"""``diff_train --data_name imagenet`` (image-folder training) of the port on
the CPU at a tiny width (16^2 RGB images, 32 channels), against the JAX CLI:

- the first batch equals the one the JAX CLI's ``next_image_batch`` hands to
  its step (captured at ``shard_batch``, before any step runs): the same
  images exactly (both load them through PIL with the same seeded order),
  labels from the file names with ``--class_cond true`` and zeros without,
  and a zero x_cond;
- two steps run with a finite loss; a missing folder raises, as in JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu.cli import diff_train as jax_diff_train
from humanliff_tpu_torch.cli import diff_train
from humanliff_tpu_torch.utils.video import write_png

FLAGS = ["--image_size", "16", "--in_channels", "3", "--out_channels", "3",
         "--num_channels", "32", "--num_res_blocks", "1", "--attention_resolutions", "8",
         "--num_heads", "2", "--batch_size", "4", "--data_name", "imagenet", "--seed", "3"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for cls in ("dog", "cat"):
        for i in range(3):
            write_png(str(root / f"{cls}_{i}.png"), rng.integers(0, 255, (20, 24, 3), np.uint8))
    return str(root)


class _Captured(Exception):
    pass


def _jax_first_batch(monkeypatch, argv):
    """The JAX CLI's first training batch, as its loop reads it."""
    def capture(batch, mesh):
        raise _Captured(batch)

    monkeypatch.setattr(jax_diff_train, "shard_batch", capture)
    monkeypatch.setattr("humanliff_tpu.utils.runtime.setup_runtime", lambda: None)
    with pytest.raises(_Captured) as exc:
        jax_diff_train.main(argv)
    return exc.value.args[0]


@pytest.mark.parametrize("class_cond", ["true", "false"])
def test_batches_match_the_jax_cli(folder, tmp_path, monkeypatch, class_cond):
    argv = FLAGS + ["--data_dir", folder, "--class_cond", class_cond]
    ref = _jax_first_batch(monkeypatch, argv + ["--logdir", str(tmp_path / "jax")])
    args = diff_train.build_parser().parse_args(argv + ["--device", "cpu"])
    batches, loader = diff_train._batches(args, torch.device("cpu"))
    assert loader is None
    got = next(batches)
    assert got["x"].shape == (4, 16, 16, 3) and got["y"].dtype == torch.int64
    np.testing.assert_array_equal(got["x"].numpy(), ref["x"])
    np.testing.assert_array_equal(got["x_cond"].numpy(), ref["x_cond"])
    assert not got["x_cond"].any()
    np.testing.assert_array_equal(got["y"].numpy(), ref["y"])
    if class_cond == "false":
        assert not got["y"].any()
    else:
        assert set(got["y"].tolist()) <= {0, 1}


def test_two_steps_on_the_cpu(folder, tmp_path):
    state = diff_train.main(FLAGS + ["--data_dir", folder, "--device", "cpu",
                                     "--microbatch", "2", "--total_steps", "2",
                                     "--log_interval", "1", "--skip_final_save", "true",
                                     "--logdir", str(tmp_path)])
    assert state.step == 2
    with open(tmp_path / "progress.json") as f:
        logs = [json.loads(line) for line in f]
    assert [m["step"] for m in logs] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in logs)
    assert not [f for f in os.listdir(tmp_path) if f.isdigit()]


def test_missing_folder_raises(tmp_path):
    with pytest.raises(ValueError, match="image folder"):
        diff_train.main(FLAGS + ["--data_dir", str(tmp_path / "none"), "--device", "cpu",
                                 "--logdir", str(tmp_path / "log")])
