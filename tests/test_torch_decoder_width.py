"""The port's NeRF decoder reads 27 plane channels only (the fused decoder
kernel is built for 27 -> 128, PE(4)), where the JAX decoder takes any
width: ``recon_train``, ``quality_eval`` and ``quality_stage2`` refuse
another ``--triplane_ch`` when they parse their flags, with the reason, on
the command line and in a ``--config`` file."""

import pytest

from humanliff_tpu_torch.cli import quality_eval, quality_stage2, recon_train
from humanliff_tpu_torch.utils import config as cfglib


@pytest.mark.parametrize("parse", [
    lambda argv: cfglib.parse_with_config(recon_train.build_parser(), argv),
    lambda argv: quality_eval.build_parser().parse_args(argv),
    lambda argv: quality_stage2.build_parser().parse_args(argv),
], ids=["recon_train", "quality_eval", "quality_stage2"])
def test_triplane_ch_other_than_27_is_refused_at_parse_time(parse, capsys):
    assert parse(["--triplane_ch", "27"]).triplane_ch == 27
    with pytest.raises(SystemExit):
        parse(["--triplane_ch", "9"])
    assert "27 -> 128, PE(4)" in capsys.readouterr().err


def test_triplane_ch_in_a_config_file_is_refused(tmp_path, capsys):
    config = tmp_path / "c.txt"
    config.write_text("triplane_ch = 9\n")
    with pytest.raises(SystemExit):
        cfglib.parse_with_config(recon_train.build_parser(), ["--config", str(config)])
    assert "triplane_ch = 9" in capsys.readouterr().err
