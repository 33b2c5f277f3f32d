"""Port parity of the body models (``humanliff_tpu_torch/bodymodel``:
``rotations``, ``kinematics``, ``smpl``, ``bigpose``) against the JAX package,
on the CPU in fp32, on toy models made from a seed (no SMPL file is read).

Bars: 1e-5 absolute on rotations, transforms, pose offsets and vertices (the
toy SMPL-shaped body's vertices reach 5 m: measured 3.4e-6); loaded models
array for array.
"""

import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from humanliff_tpu.bodymodel import bigpose as jbig
from humanliff_tpu.bodymodel import kinematics as jkin
from humanliff_tpu.bodymodel import rotations as jrot
from humanliff_tpu.bodymodel import smpl as jsmpl
from humanliff_tpu.data import synbody as jsynbody
from humanliff_tpu_torch.bodymodel import bigpose, kinematics, rotations, smpl
from humanliff_tpu_torch.data import synbody

ATOL = 1e-5


def _pair(J=4, V=64, n_betas=5, seed=0):
    return (jsmpl.make_synthetic_body_model(J, V, n_betas, seed),
            smpl.make_synthetic_body_model(J, V, n_betas, seed))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("J,V,n_betas", [(4, 64, 5), (24, 6890, 10)])
def test_synthetic_body_model_is_jax_array_for_array(J, V, n_betas):
    jm, pm = _pair(J, V, n_betas)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "parents"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name), err_msg=name)
    assert pm.parents[0] == 0 and pm.num_joints == J and pm.num_verts == V


@pytest.mark.parametrize("scale", [0.0, 0.3, 1.5])
def test_batch_rodrigues_matches_jax(scale):
    vecs = np.random.default_rng(1).normal(scale=scale, size=(5, 7, 3)).astype(np.float32)
    got = rotations.batch_rodrigues(_t(vecs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrot.batch_rodrigues(jnp.asarray(vecs))),
                               atol=ATOL)
    assert got.shape == (5, 7, 3, 3)


def test_rigid_transform_chain_matches_jax():
    jm, pm = _pair(J=24, V=500)
    rng = np.random.default_rng(2)
    rot = np.asarray(jrot.batch_rodrigues(jnp.asarray(
        rng.normal(scale=0.4, size=(3, 24, 3)).astype(np.float32))))
    joints = rng.normal(size=(3, 24, 3)).astype(np.float32)
    want = np.asarray(jkin.rigid_transform_chain(jnp.asarray(rot), jnp.asarray(joints),
                                                 jm.parents))
    got = kinematics.rigid_transform_chain(_t(rot), _t(joints), pm.parents).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _smpl_inputs(J, n_betas, B=2, seed=3, pose_scale=0.4):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=pose_scale, size=(B, J * 3)).astype(np.float32),
            rng.normal(scale=1.0, size=(B, n_betas)).astype(np.float32))


@pytest.mark.parametrize("n_used", [10, 6])
def test_transform_params_and_offsets_match_jax(n_used):
    """The shape bank is sliced to the caller's betas (6 of 10 here)."""
    jm, pm = _pair(J=24, V=6890, n_betas=10)
    poses, betas = _smpl_inputs(24, n_used)
    jA, jj = jsmpl.transform_params(jm, jnp.asarray(poses), jnp.asarray(betas))
    A, joints = smpl.transform_params(pm, _t(poses), _t(betas))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=ATOL)
    np.testing.assert_allclose(joints.numpy(), np.asarray(jj), atol=ATOL)
    np.testing.assert_allclose(smpl._shaped_template(pm, _t(betas)).numpy(),
                               np.asarray(jsmpl._shaped_template(jm, jnp.asarray(betas))),
                               atol=ATOL)
    rot = rotations.batch_rodrigues(_t(poses).reshape(2, -1, 3))
    want = np.asarray(jsmpl._pose_offsets(jm, jnp.asarray(rot.numpy())))
    got = smpl._pose_offsets(pm, rot).numpy()
    assert got.shape == (2, 6890, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("global_rt", [False, True])
def test_lbs_forward_matches_jax(global_rt):
    jm, pm = _pair(J=24, V=6890, n_betas=10)
    poses, betas = _smpl_inputs(24, 10)
    kw_j, kw_p = {}, {}
    if global_rt:
        rng = np.random.default_rng(4)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = np.stack([q, q.T]).astype(np.float32)
        t = rng.normal(scale=2.0, size=(2, 3)).astype(np.float32)
        kw_j = dict(global_rot=jnp.asarray(R), global_trans=jnp.asarray(t))
        kw_p = dict(global_rot=_t(R), global_trans=_t(t))
    jv, jj = jsmpl.lbs_forward(jm, jnp.asarray(poses), jnp.asarray(betas), **kw_j)
    v, j = smpl.lbs_forward(pm, _t(poses), _t(betas), **kw_p)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), atol=ATOL)
    np.testing.assert_allclose(smpl.lbs_forward_np(pm, poses[0], betas[0]), np.asarray(
        jsmpl.lbs_forward(jm, jnp.asarray(poses[:1]), jnp.asarray(betas[:1]))[0][0]),
        atol=ATOL)


def _toy_smplx(V=40, J=5, seed=0):
    """A SMPL-X-like toy model: expression blendshapes."""
    rng = np.random.default_rng(seed)
    jm = jsmpl.make_synthetic_body_model(J, V, 10, seed)
    expr = rng.normal(scale=0.005, size=(V, 3, 10)).astype(np.float32)
    fields = {k: getattr(jm, k) for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                                          "weights", "parents")}
    return (jsmpl.BodyModel(**fields, expr_dirs=expr), smpl.BodyModel(**fields, expr_dirs=expr))


def test_lbs_forward_with_expression_matches_jax():
    jm, pm = _toy_smplx()
    poses, betas = _smpl_inputs(5, 10)
    expr = np.random.default_rng(6).normal(size=(2, 10)).astype(np.float32)
    trans = np.random.default_rng(7).normal(size=(2, 3)).astype(np.float32)
    jv, _ = jsmpl.lbs_forward(jm, jnp.asarray(poses), jnp.asarray(betas),
                              expression=jnp.asarray(expr), global_trans=jnp.asarray(trans))
    v, _ = smpl.lbs_forward(pm, _t(poses), _t(betas), expression=_t(expr),
                            global_trans=_t(trans))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
    # The expression moves the vertices.
    v0, _ = smpl.lbs_forward(pm, _t(poses), _t(betas), global_trans=_t(trans))
    assert float((v - v0).abs().max()) > 1e-3


def _model_file_dict(V=30, J=4, smplx=False, seed=0):
    """A model file's dict as the SMPL/SMPL-X distributions lay it out: a
    sparse J_regressor, posedirs (V, 3, (J-1)*9), for SMPL-X 400 shapedirs
    columns (300 shape | 100 expression)."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    n_shape = 400 if smplx else 10
    jreg = np.zeros((J, V), np.float64)
    jreg[np.arange(J), rng.integers(0, V, J)] = 1.0
    kintree = np.stack([np.concatenate([[4294967295], np.arange(J - 1)]), np.arange(J)])
    return {
        "v_template": rng.normal(size=(V, 3)),
        "shapedirs": rng.normal(scale=0.01, size=(V, 3, n_shape)),
        "posedirs": rng.normal(scale=0.001, size=(V, 3, (J - 1) * 9)),
        "J_regressor": sparse.csc_matrix(jreg),
        "weights": rng.dirichlet(np.ones(J), size=V),
        "kintree_table": kintree,
        "f": rng.integers(0, V, size=(8, 3)),
    }


@pytest.mark.parametrize("fmt,smplx", [("pkl", False), ("npz", False), ("pkl", True),
                                       ("npz", True)])
def test_load_body_model_matches_jax(tmp_path, fmt, smplx):
    """A toy model written as a latin1 pickle (SMPL's format) or an npz
    (SMPL-X's distribution) loads to JAX's arrays: the sparse J_regressor
    densified, posedirs in the reference layout, SMPL-X's 300 | 10 split;
    each path is read once."""
    data = _model_file_dict(smplx=smplx)
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "pkl":
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)
    else:
        np.savez(path, **{k: (v.toarray() if k == "J_regressor" else v) for k, v in data.items()})
    want = jsmpl.load_body_model(path)
    got = smpl.load_body_model(path)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "parents",
                 "expr_dirs", "faces"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.posedirs.shape == (30 * 3, 27)
    assert (got.expr_dirs is not None) == smplx and got.shapedirs.shape[-1] == (300 if smplx
                                                                                else 10)
    assert smpl.load_body_model(path) is got
    os.remove(path)
    assert smpl.load_body_model(path) is got  # the cache, not the file


def test_find_smplx_model_prefers_npz(tmp_path):
    for ext in (".pkl", ".npz"):
        (tmp_path / f"SMPLX_MALE{ext}").write_bytes(b"")
    assert smpl.find_smplx_model(str(tmp_path), "male").endswith("SMPLX_MALE.npz")
    assert (smpl.find_smplx_model(str(tmp_path), "male")
            == jsmpl.find_smplx_model(str(tmp_path), "male"))
    with pytest.raises(FileNotFoundError, match="SMPLX_FEMALE"):
        smpl.find_smplx_model(str(tmp_path), "female")


@pytest.mark.parametrize("dim", [12, 72, 165])
def test_big_poses_match_jax(dim):
    np.testing.assert_array_equal(bigpose.big_pose_params(dim), jbig.big_pose_params(dim))
    np.testing.assert_array_equal(synbody.smplx_big_pose(dim // 3),
                                  jsynbody.smplx_big_pose(dim // 3))


def test_arrays_move_to_a_device_once():
    _, pm = _pair()
    a = pm.tensors("cpu")
    assert pm.tensors(torch.device("cpu")) is a
    assert a["weights"].dtype == torch.float32 and "expr_dirs" not in a
