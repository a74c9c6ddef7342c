"""PV-RCNN's point ops against the JAX package on the CPU: furthest point
sampling, ball query, grouping, multi-scale set abstraction and the BEV
bilinear gather.

Inputs are made with numpy from a seed and go through both packages; JAX
runs under ``jax.jit`` only. Indices and ``valid`` must be equal: the
port's squared distance rounds as XLA's CPU code does
(``ops.fps.squared_distance``). Float tolerances are stated where used;
oneDNN is off where the port multiplies (its GEMMs are not the reference
f32 order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision3d_tpu.config import Config
from vision3d_tpu.models.pointnet import SetAbstractionMSG as JSA
from vision3d_tpu.models.pvrcnn import bev_bilinear_gather as j_bev_gather
from vision3d_tpu.ops.ball_query import ball_query as j_ball_query
from vision3d_tpu.ops.ball_query import group_features as j_group_features
from vision3d_tpu.ops.fps import sample_keypoints as j_sample_keypoints
from vision3d_tpu_torch import convert, kernels
from vision3d_tpu_torch.models.pointnet import SetAbstractionMSG
from vision3d_tpu_torch.models.pvrcnn import bev_bilinear_gather
from vision3d_tpu_torch.ops.ball_query import ball_query, group_features
from vision3d_tpu_torch.ops.fps import (furthest_point_sample, furthest_point_sample_plain,
                                        sample_keypoints)
from vision3d_tpu_torch.synthetic import kitti_like_points

from torch_parity import port_cfg

RADII = (0.4, 0.8, 1.2, 2.4, 4.8)


def _clouds(seed, n=600):
    """Three clouds of n points: uniform, KITTI-like (near ties: a ground
    plane and box faces), and a tight cluster with duplicates."""
    rng = np.random.default_rng(seed)
    uni = rng.uniform([0, -12.8, -3], [25.6, 12.8, 1], (n, 3))
    kit = kitti_like_points(rng, 4 * n)[:n, :3]
    clus = rng.normal(0, 0.3, (n, 3)).round(1) + [5.0, 0.0, -1.0]
    return np.stack([uni, kit, clus]).astype(np.float32)


def _j_fps(xyz, mask, k):
    kp = jax.jit(j_sample_keypoints, static_argnums=2)(xyz, mask, k)
    from vision3d_tpu.ops.fps import furthest_point_sample as jf

    idx = jax.jit(jax.vmap(lambda x, m: jf(x, m, k)))(xyz, mask)
    return np.asarray(kp), np.asarray(idx)


@pytest.mark.parametrize("case", [0, 1, "ties"])
def test_fps_indices_equal_jax(case):
    """All valid; 40 valid of 600 with K = 64 (the loop repeats points at
    distance 0); none valid (all indices 0); valid points not first. In the
    "ties" case every point appears twice (point i + 300 is point i) and the
    last cloud is the tight cluster, rounded to 0.1 m (many equal points):
    equal running distances go to the lower index."""
    ties = case == "ties"
    xyz = _clouds(0, 300) if ties else _clouds(case)
    if ties:
        xyz = np.concatenate([xyz, xyz], axis=1)
    n = xyz.shape[1]
    mask = np.ones((3, n), bool)
    mask[1, 40:] = False
    mask[2] = False
    xyz4 = np.concatenate([xyz, xyz[2:] if ties else xyz[:1]])
    mask4 = np.concatenate([mask, (np.arange(n) >= 100)[None]])
    jkp, jidx = _j_fps(jnp.asarray(xyz4), jnp.asarray(mask4), 64)
    tidx = furthest_point_sample(torch.from_numpy(xyz4), torch.from_numpy(mask4), 64)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert (jidx[2] == 0).all() and jidx[3, 0] == 100
    assert len(set(jidx[1])) == 40                    # repeats once all are taken
    if ties:              # each keypoint is the first valid point at its place
        for c in (0, 3):
            same = (xyz4[c][:, None] == xyz4[c][None, jidx[c]]).all(-1) & mask4[c][:, None]
            np.testing.assert_array_equal(same.argmax(0), jidx[c])
        assert (jidx[0] < 300).all()
    tkp, _ = sample_keypoints(torch.from_numpy(xyz4), torch.from_numpy(mask4), 64)
    np.testing.assert_array_equal(tkp.numpy(), jkp)


def test_fps_on_cpu_runs_the_plain_version():
    """On CPU tensors furthest_point_sample is furthest_point_sample_plain:
    no kernel launch; malformed input and K < 1 raise, a device that is
    neither the CPU nor a card raises."""
    xyz = _clouds(3, 200)
    mask = np.ones((3, 200), bool)
    mask[1, 150:] = False
    before = kernels.LAUNCHES["fps"]
    got = furthest_point_sample(torch.from_numpy(xyz), torch.from_numpy(mask), 32)
    want = furthest_point_sample_plain(torch.from_numpy(xyz), torch.from_numpy(mask), 32)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert kernels.LAUNCHES["fps"] == before == 0
    with pytest.raises(ValueError):
        furthest_point_sample(torch.from_numpy(xyz), torch.from_numpy(mask), 0)
    with pytest.raises(ValueError):
        furthest_point_sample(torch.from_numpy(xyz[..., :2]), torch.from_numpy(mask), 8)
    with pytest.raises(ValueError):
        furthest_point_sample(torch.from_numpy(xyz), torch.from_numpy(mask[:, :100]), 8)
    with pytest.raises(ValueError):
        furthest_point_sample(torch.from_numpy(xyz).to("meta"),
                              torch.from_numpy(mask).to("meta"), 8)


def test_fps_full_kitti_cloud_equal_jax():
    """1024 keypoints of a 6000-point KITTI-like cloud."""
    pts = kitti_like_points(np.random.default_rng(5), 8000)[:6000, :3].astype(np.float32)
    mask = np.ones((1, 6000), bool)
    _, jidx = _j_fps(jnp.asarray(pts[None]), jnp.asarray(mask), 1024)
    tidx = furthest_point_sample(torch.from_numpy(pts[None]), torch.from_numpy(mask), 1024)
    np.testing.assert_array_equal(tidx.numpy(), jidx)


def _ball_case(seed):
    """Sources with a padding tail, centres on sources (full balls that
    need the first nsample), jittered (balls to fill) and far away
    (empty balls)."""
    rng = np.random.default_rng(seed)
    src = _clouds(seed, 500)[:2]
    mask = np.ones((2, 500), bool)
    mask[1, 450:] = False
    ctr = np.concatenate([src[:, :40] + rng.normal(0, 0.3, (2, 40, 3)),
                          rng.uniform(-50, -40, (2, 8, 3))], axis=1).astype(np.float32)
    return src, mask, ctr


@pytest.mark.parametrize("nsample", [16, 32])
@pytest.mark.parametrize("radius", RADII)
def test_ball_query_equal_jax(radius, nsample):
    src, mask, ctr = _ball_case(int(radius * 10) + nsample)
    jq = jax.jit(jax.vmap(lambda s, m, c: j_ball_query(s, m, c, radius, nsample)))
    jidx, jvalid = (np.asarray(a) for a in jq(src, mask, ctr))
    # a small budget: the port's chunks of centres take every remainder
    tidx, tvalid = ball_query(torch.from_numpy(src), torch.from_numpy(mask),
                              torch.from_numpy(ctr), radius, nsample, budget=7000)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tvalid.numpy(), jvalid)
    assert not jvalid[:, 40:].any()                   # the far centres: empty
    assert (jidx[:, 40:] == 0).all()
    counts = jvalid[:, :40, 0].sum()
    assert counts > 0


def test_ball_query_cpu_is_the_plain_version_and_launches_nothing():
    """On CPU tensors ``ball_query`` runs ``ball_query_plain`` (the CUDA
    kernel is held bit-equal to it on the card, tests/test_torch_cuda.py),
    launches no kernel, and takes non-contiguous inputs."""
    from vision3d_tpu_torch import kernels
    from vision3d_tpu_torch.ops.ball_query import ball_query_plain

    src, mask, ctr = (torch.from_numpy(a) for a in _ball_case(5))
    wide = torch.stack([src, src], dim=-1)[..., 0]            # not contiguous
    before = kernels.LAUNCHES["ball_query"]
    for r, s in ((0.8, 16), (2.4, 32)):
        got = ball_query(wide, mask, ctr, r, s)
        want = ball_query_plain(src, mask, ctr, r, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.LAUNCHES["ball_query"] == before


def test_ball_query_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused before any
    launch; no stand-in runs."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ball_query(torch.empty((1, 4, 3), device=meta), torch.empty((1, 4), dtype=torch.bool,
                                                                  device=meta),
                   torch.empty((1, 2, 3), device=meta), 1.0, 4)


def test_group_features_equal_jax():
    """A gather and one float32 subtraction: equal to the bit."""
    src, mask, ctr = _ball_case(3)
    feats = np.random.default_rng(3).normal(size=(2, 500, 5)).astype(np.float32)
    jq = jax.jit(jax.vmap(lambda s, m, c: j_ball_query(s, m, c, 1.2, 16)))
    jidx, jvalid = jq(src, mask, ctr)
    want = jax.jit(jax.vmap(j_group_features))(src, feats, jidx, jvalid, ctr)
    want_xyz = jax.jit(jax.vmap(lambda s, i, v, c: j_group_features(s, None, i, v, c)))(
        src, jidx, jvalid, ctr)
    t = [torch.from_numpy(np.asarray(a)) for a in (src, feats, jidx, jvalid, ctr)]
    got = group_features(t[0], t[1], t[2].long(), t[3], t[4])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_xyz = group_features(t[0], None, t[2].long(), t[3], t[4])
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))


def perturb(variables, seed):
    """Seeded noise on BN statistics, scales and biases (and a little on
    every other leaf), so no batch norm is an identity."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "var":
            return x * rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return x + rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name == "scale":
            return x * rng.uniform(0.7, 1.3, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, variables)


def sa_state_dict(variables, prefix="pnets.0."):
    """A lone SetAbstractionMSG's flax tree -> the port module's state_dict
    (through convert.py's PV-RCNN rules, as pnets_0)."""
    tree = convert._pvrcnn_from_flax({k: {"pnets_0": v} for k, v in variables.items()})
    return {k[len(prefix):]: v for k, v in tree.items()}


@pytest.mark.parametrize("with_feats", [True, False])
def test_set_abstraction_matches_jax(with_feats):
    """Two radii, layers without bias + masked BN (eps 1e-5) + ReLU, masked
    max with zeros for empty balls. float32 GEMMs in other orders: 1e-5
    of the output scale."""
    src, mask, ctr = _ball_case(11)
    c = 6 if with_feats else 0
    feats = (np.random.default_rng(11).normal(size=(2, 500, c)).astype(np.float32)
             if with_feats else None)
    radii, nsamples, mlps = (0.8, 2.4), (16, 32), ((8, 16), (16, 24))
    jsa = JSA(radii=radii, nsamples=nsamples, mlps=mlps)
    args = (src, feats, mask, ctr)
    variables = jax.jit(lambda r: jsa.init(r, *args))(jax.random.PRNGKey(4))
    variables = perturb(variables, 4)
    want = np.asarray(jax.jit(lambda v: jsa.apply(v, *args))(variables))
    tsa = SetAbstractionMSG(c, radii, nsamples, mlps)
    tsa.load_state_dict(sa_state_dict(variables), strict=True)
    tsa.eval()
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = tsa(torch.from_numpy(src), None if feats is None else torch.from_numpy(feats),
                  torch.from_numpy(mask), torch.from_numpy(ctr)).numpy()
    assert got.shape == want.shape == (2, 48, 40)
    assert (want[:, 40:] == 0).all() and (got[:, 40:] == 0).all()
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-5)


def test_bev_bilinear_gather_matches_jax():
    """Keypoints inside, on the edge of and outside the map (clamped): the
    interpolation weights in float32 in another order, 1e-6 of the scale."""
    cfg = Config().replace(voxel_size=(0.4, 0.4, 0.1),
                           grid_bounds=(0.0, -12.8, -3.0, 25.6, 12.8, 1.0))
    ny, nx = cfg.bev_shape
    rng = np.random.default_rng(6)
    bev = rng.normal(size=(2, ny, nx, 5)).astype(np.float32)
    xy = rng.uniform([-3, -16], [29, 16], (2, 50, 2)).astype(np.float32)
    xy[:, 0] = [0.0, -12.8]
    xy[:, 1] = [25.6, 12.8]
    want = np.asarray(jax.jit(lambda b, k: j_bev_gather(b, k, cfg))(bev, xy))
    got = bev_bilinear_gather(torch.from_numpy(bev), torch.from_numpy(xy),
                              port_cfg(cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=1e-6)


def test_shared_mlp_stays_float32_under_bf16():
    """The Linear layers carry no compute dtype (nor do the JAX Dense
    layers): bf16 source features are grouped and multiplied in float32."""
    tsa = SetAbstractionMSG(1, (0.8,), (16,), ((8,),)).eval()
    src, mask, ctr = _ball_case(2)
    with torch.no_grad():
        out = tsa(torch.from_numpy(src), torch.from_numpy(src[..., :1]).bfloat16(),
                  torch.from_numpy(mask), torch.from_numpy(ctr))
    assert out.dtype == torch.float32
