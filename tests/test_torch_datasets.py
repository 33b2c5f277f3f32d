"""Port parity of the capture loaders (``data/raygen.py``, ``data/tightcap.py``,
``data/synbody.py``, ``data/view_datasets.py``) against the JAX package, on
fabricated SynBody and TightCap trees (tests/test_datasets.py's writers) and
toy body models.

Items match JAX's: the same keys, the same ray samples for the same numpy
generator, arrays within 1e-5 (the SMPL forward runs in torch on one side
and in JAX on the other: measured at most 7.2e-7).
"""

import json
import os

import numpy as np
import pytest

from humanliff_tpu.data import raygen as jraygen
from humanliff_tpu.data import synbody as jsynbody
from humanliff_tpu.data import tightcap as jtightcap
from humanliff_tpu.data import view_datasets as jviews
from humanliff_tpu_torch.bodymodel import smpl
from humanliff_tpu_torch.data import raygen, synbody, tightcap, view_datasets

imageio = pytest.importorskip("imageio.v2")
cv2 = pytest.importorskip("cv2")

from test_datasets import _toy_body, _write_cameras, _write_view_images  # noqa: E402

ATOL = 1e-5


def port_body(jax_body):
    """The port's BodyModel of a JAX toy model's arrays."""
    return smpl.BodyModel(**{k: getattr(jax_body, k) for k in (
        "v_template", "shapedirs", "posedirs", "J_regressor", "weights", "parents",
        "expr_dirs", "faces")})


def assert_items_equal(got, want, label=""):
    assert sorted(got) == sorted(want), label
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, (label, k, a.shape, b.shape)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"{label} {k}")


def write_tightcap_tree(root, body, views=3, poses=2, size=32, seed=0):
    """A TightCap subject ``tc0`` under ``root``: images and masks of the full
    capture and each garment, cameras, and a refit with seeded poses, betas
    and a translation that centres the body at the origin."""
    rng = np.random.default_rng(seed)
    subj = os.path.join(root, "tc0")
    os.makedirs(subj)
    with open(os.path.join(root, "TightCap_human_list.txt"), "w") as f:
        f.write("tc0\n")
    _write_view_images(subj, [tightcap.FULL_DIR, *tightcap.GARMENT_DIRS.values()], views, poses,
                       size)
    _write_cameras(os.path.join(subj, tightcap.FULL_DIR, "cameras.json"), views, size)
    os.makedirs(os.path.join(subj, tightcap.FULL_DIR, "outputs_re_fitting"))
    J = body.num_joints
    params = {
        "global_orient": rng.normal(scale=0.2, size=(poses, 3)).astype(np.float32),
        "body_pose": rng.normal(scale=0.3, size=(poses, (J - 1) * 3)).astype(np.float32),
        "betas": rng.normal(scale=0.5, size=(10,)).astype(np.float32),
        "transl": np.tile(-body.v_template.mean(0), (poses, 1)).astype(np.float32),
    }
    np.savez(os.path.join(subj, tightcap.FULL_DIR, "outputs_re_fitting", "refit_smpl_2nd.npz"),
             smpl=np.asarray(params, dtype=object))
    return subj


def write_synbody_tree(root, body, views=3, poses=2, size=32, seed=0):
    """A SynBody subject ``subj0``: the four layer directories, cameras and a
    seeded SMPL-X fit (J 5: global, body, jaw and eye poses, no hands)."""
    rng = np.random.default_rng(seed)
    subj = os.path.join(root, "subj0")
    os.makedirs(subj)
    with open(os.path.join(root, "human_list.txt"), "w") as f:
        f.write("subj0\n")
    _write_cameras(os.path.join(subj, "cameras.json"), views, size)
    _write_view_images(subj, synbody.LAYER_DIRS, views, poses, size)
    params = {k: rng.normal(scale=0.2, size=(poses, 3)).astype(np.float32)
              for k in ("global_orient", "body_pose", "jaw_pose", "leye_pose", "reye_pose")}
    params.update(
        left_hand_pose=np.zeros((poses, 0), np.float32),
        right_hand_pose=np.zeros((poses, 0), np.float32),
        betas=rng.normal(scale=0.5, size=(10,)).astype(np.float32),
        expression=rng.normal(size=(poses, 10)).astype(np.float32),
        transl=np.tile(-body.v_template.mean(0), (poses, 1)).astype(np.float32))
    np.savez(os.path.join(subj, "smplx.npz"), smplx=np.asarray(params, dtype=object),
             meta=np.asarray({"gender": "female"}, dtype=object))
    return subj


@pytest.fixture(scope="module")
def tightcap_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tightcap"))
    body = _toy_body(V=48, J=4)
    subj = write_tightcap_tree(root, body)
    kw = dict(data_root=subj, num_instances=1, views_num=3, poses_num=2, n_rays=64,
              image_scaling=1.0)
    return (jtightcap.TightCapDataset(body_model=body, **kw),
            tightcap.TightCapDataset(body_model=port_body(body), **kw))


@pytest.fixture(scope="module")
def synbody_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synbody"))
    body = _toy_body(V=40, J=5, smplx=True)
    subj = write_synbody_tree(root, body)
    other = _toy_body(V=40, J=5, smplx=True, seed=1)
    jmodels = {"female": body, "male": other, "neutral": other}
    kw = dict(data_root=subj, num_instances=1, views_num=3, poses_num=2, n_rays=64,
              image_scaling=0.5)
    return (jsynbody.SynBodyDataset(body_models=jmodels, **kw),
            synbody.SynBodyDataset(body_models={g: port_body(m) for g, m in jmodels.items()},
                                   **kw))


@pytest.mark.parametrize("split", ["train", "test"])
def test_tightcap_items_match_jax(tightcap_pair, split):
    """Every layer's composite, both poses, each view's camera: the same
    rays for the same generator, the SMPL arrays, the big pose's bounds."""
    jds, ds = tightcap_pair
    jds.split = ds.split = split
    assert len(ds) == len(jds) == 4 * 2 * 3
    np.testing.assert_allclose(ds.t_world_bounds, jds.t_world_bounds, atol=ATOL)
    for index in (0, 4, 9, 14, 23):
        got = ds.item(index, np.random.default_rng(index))
        want = jds.item(index, np.random.default_rng(index))
        assert_items_equal(got, want, f"{split} {index}")
    jds.split = ds.split = "train"


@pytest.mark.parametrize("split", ["train", "test"])
def test_synbody_items_match_jax(synbody_pair, split):
    """World space, the gender's SMPL-X model with expressions, images at
    half scale (cv2.resize)."""
    jds, ds = synbody_pair
    jds.split = ds.split = split
    np.testing.assert_allclose(ds.t_vertices, jds.t_vertices, atol=ATOL)
    for index in (0, 5, 13, 23):
        got = ds.item(index, np.random.default_rng(index))
        want = jds.item(index, np.random.default_rng(index))
        assert_items_equal(got, want, f"{split} {index}")
    assert got["rays_o"].shape[0] == (64 if split == "train" else 16 * 16)
    jds.split = ds.split = "train"


def test_test_item_is_the_jax_recon_test_index(tightcap_pair, synbody_pair):
    """test_item(subject, layer, view) is JAX recon_test's item(subject * 4 *
    per_layer + layer * per_layer + view) in the test split."""
    for jds, ds in (tightcap_pair, synbody_pair):
        jds.split = "test"
        per_layer = jds.poses_num * jds.views_num
        assert_items_equal(ds.test_item(0, 2, 1), jds.item(2 * per_layer + 1))
        jds.split = "train"


def test_build_item_from_arrays_is_the_file_item(tightcap_pair):
    """The array half alone, on the arrays read_view returns, gives item()."""
    _, ds = tightcap_pair
    arrays = ds.read_view(7)
    got = tightcap.build_item(ds.body_model, **arrays, t_pose=ds.t_pose,
                              t_world_bounds=ds.t_world_bounds, n_rays=64,
                              rng=np.random.default_rng(3))
    assert_items_equal(got, ds.item(7, np.random.default_rng(3)))


def test_composite_layer_image_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(20, 20, 3)).astype(np.float32)
    full = (rng.uniform(size=(20, 20)) < 0.8).astype(np.float32)
    garments = {k: (rng.uniform(size=(20, 20)) < 0.4).astype(np.float32)
                for k in ("naked", "top", "bottom", "shoes")}
    for layer in range(4):
        got = tightcap.composite_layer_image(layer, img, full, garments)
        want = jtightcap.composite_layer_image(layer, img, full, garments)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _camera(size=40):
    """K, R, T of camera 1 of tests/test_datasets.py's three."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _write_cameras(os.path.join(d, "cameras.json"), 3, size)
        with open(os.path.join(d, "cameras.json")) as f:
            cam = json.load(f)["camera0001"]
    return (np.asarray(cam["K"], np.float64), np.asarray(cam["R"], np.float64),
            np.asarray(cam["T"], np.float64).reshape(3, 1))


BOUNDS = np.asarray([[-0.4, -0.5, -0.3], [0.3, 0.6, 0.4]], np.float32)


@pytest.mark.parametrize("with_cv2", [True, False])
def test_training_rays_match_jax(monkeypatch, with_cv2):
    """The projected-box mask (cv2.fillPoly; every pixel without OpenCV, as
    in JAX) and the weighted rejection sampler, the same rays for the same
    generator."""
    K, R, T = _camera()
    pose = np.concatenate([R, T], axis=1)
    if not with_cv2:
        monkeypatch.setattr(jraygen, "cv2", None)
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    got_mask = raygen.get_bound_2d_mask(BOUNDS, K, pose, 40, 40)
    np.testing.assert_array_equal(got_mask, jraygen.get_bound_2d_mask(BOUNDS, K, pose, 40, 40))
    assert 0 < got_mask.mean() < 1 if with_cv2 else got_mask.all()
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(40, 40, 3)).astype(np.float32)
    msk = np.zeros((40, 40), np.float32)
    msk[15:25, 12:28] = 1
    got = raygen.sample_ray_batch_train(img, msk, K, R, T, BOUNDS, 100,
                                        rng=np.random.default_rng(5))
    want = jraygen.sample_ray_batch_train(img, msk, K, R, T, BOUNDS, 100,
                                          rng=np.random.default_rng(5))
    assert_items_equal(got, want)
    assert (got["far"] > got["near"]).all() and 0 < got["bkgd"].mean() < 1


def test_unproject_depth_matches_jax():
    K, R, T = _camera()
    depth = np.random.default_rng(0).uniform(2, 3, size=(40, 40)).astype(np.float32)
    np.testing.assert_allclose(raygen.unproject_depth(depth, K, R, T),
                               jraygen.unproject_depth(depth, K, R, T), atol=1e-6)


@pytest.mark.parametrize("kind", ["tightcap", "synbody"])
def test_view_datasets_match_jax(tmp_path, kind):
    """Novel-view items: the base dataset's test items at the view ids, the
    plane pair from the packed array (zeros for layer 0's condition), y and
    the big pose's bounds."""
    packed = np.random.default_rng(0).normal(size=(1, 4, 27, 8, 8)).astype(np.float32)
    np.save(tmp_path / "packed.npy", packed)
    if kind == "tightcap":
        body = _toy_body(V=48, J=4)
        subj = write_tightcap_tree(str(tmp_path / "data"), body, views=4, poses=1)
        pair = (jviews.TightCapViewDataset(data_root=subj, body_model=body,
                                           triplane_packed=str(tmp_path / "packed.npy"),
                                           layer_idx=2, output_views=[1, 3]),
                view_datasets.TightCapViewDataset(data_root=subj, body_model=port_body(body),
                                                  triplane_packed=str(tmp_path / "packed.npy"),
                                                  layer_idx=2, output_views=[1, 3]))
    else:
        body = _toy_body(V=40, J=5, smplx=True)
        subj = write_synbody_tree(str(tmp_path / "data"), body, views=4, poses=1)
        models = {g: body for g in ("male", "female", "neutral")}
        pair = (jviews.SynBodyViewDataset(data_root=subj, body_models=models, layer_idx=0,
                                          triplane_packed=str(tmp_path / "packed.npy"),
                                          output_views=[0, 2]),
                view_datasets.SynBodyViewDataset(
                    data_root=subj, body_models={g: port_body(body) for g in models},
                    triplane_packed=str(tmp_path / "packed.npy"), layer_idx=0,
                    output_views=[0, 2]))
    jds, ds = pair
    assert len(ds) == len(jds) == 2
    for i in range(2):
        assert_items_equal(ds.item(i), jds.item(i), f"{kind} {i}")
    item = ds.item(1)
    layer = 2 if kind == "tightcap" else 0
    np.testing.assert_array_equal(item["x"], packed[0, layer])
    assert int(item["y"]) == layer and (item["x_cond"] == 0).all() == (layer == 0)


def test_loader_raises_a_worker_exception():
    """A failing item reaches the training loop as its exception; before,
    the worker thread died and the loop waited for a batch forever."""
    from humanliff_tpu_torch.data.loader import BatchLoader

    def item(i, rng):
        if i == 3:
            raise IndexError("item 3 is missing")
        return {"a": np.zeros(2, np.float32)}

    loader = BatchLoader(num_items=8, item_fn=item, batch_size=4, seed=0, num_workers=2)
    try:
        with pytest.raises(IndexError, match="item 3"):
            for _ in range(1000):
                next(iter(loader))
    finally:
        loader.close()
