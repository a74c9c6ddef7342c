"""Z-window sparse conv: wrappers of the CUDA kernels ``csrc/zwin_conv.cu``
and ``csrc/zwin_align_gemm.cu``.

``zwin_conv`` is the port of the TPU kernel
``vision3d_tpu/ops/pallas/zwin_conv.py:114`` (``zwin_conv_gemm_v2`` behind
``conv_zwin_apply_pallas2``), the one the model runs. The TPU wrapper
gathered the z-window rows and built the tap masks in XLA before the
kernel; the CUDA kernels read ``(feats, start, pattern)`` themselves. Two
routes, picked by ``gather_gemm.route_of(compute_dtype, C, Cout)``, the
rule of the rulebook gather-GEMM: ``"mma"`` (tensor cores: each tile of 64
sites builds its 27-tap rulebook in shared memory from ``(start,
pattern)`` and runs the gather-GEMM tile of ``csrc/gather_tile_mma.cuh``)
for bfloat16 with ``C % 16 == 0``; ``"fma"`` (float32 FMA) for float32,
whose card-vs-CPU checks need exact products, and for C = 4. One route
never stands in for the other: a failed launch raises.

``zwin_align_gemm_v1`` / ``_v3`` are the ports of the two other TPU
variants, ``zwin_conv_gemm`` (``zwin_conv.py:55``) and
``zwin_conv_gemm_v3`` (``zwin_conv.py:238``): they take ALREADY GATHERED
k2-major windows plus tap masks, v1 as ``(dz, j)`` pairs, v3 as shift
masks. ``conv_zwin_apply_v1`` / ``_v3`` gather the windows and build the
masks in plain PyTorch (XLA code in the JAX package) and then call them,
with the contract of ``conv_zwin_apply_pallas`` / ``conv_zwin_apply_pallas3``.
They take the same two routes by the same rule: on "mma" the windows are
one flat table of C-wide rows and each tile builds its 27-tap rulebook
from the masks in shared memory (a tile whose masks route a second or
third candidate to one tap runs again on those, adding to its output).
No model path runs them; ``tools/microbench_torch_zwin.py`` times all
three variants on one set of rulebooks.

On a CPU tensor each wrapper runs its plain PyTorch version
(``ops.sparse.conv_zwin_apply``, ``zwin_align_gemm_v1_plain``,
``zwin_align_gemm_v3_plain``); on a CUDA tensor it launches the kernel or
raises. ``LAUNCHES`` counts kernel launches under ``zwin_conv``,
``zwin_align_v1`` and ``zwin_align_v3``, and per route under
``<kernel>.mma`` / ``<kernel>.fma``.
"""

import ctypes

import torch

from vision3d_tpu_torch import kernels
from vision3d_tpu_torch.ops import sparse as sp
from vision3d_tpu_torch.ops.gather_gemm import aligned16, pick_route

LAUNCHES = kernels.LAUNCHES
ROUTES = kernels.ROUTES["zwin_conv"]
reset_launches = kernels.reset_launches
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COUTS = (16, 32, 64, 128)
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 5 + [_CI] * 7 + [_VP]


def embed_333(start, pattern, weight, kernel, n):
    """A z-window rulebook and weight of kernel (3, ky, kx), ky and kx 1 or
    3, as those of the (3, 3, 3) conv that the kernel runs: each of the
    rulebook's ky*kx windows goes to its place in the centred 3 x 3 of BEV
    offsets, the others are misses (start ``n``, pattern 0), and the
    weight's taps go to the same places among 27, the others zero. The
    conv is the same: a miss reads no row."""
    kz, ky, kx = kernel
    if kz != 3 or ky not in (1, 3) or kx not in (1, 3):
        raise ValueError(f"zwin_conv: kernel {tuple(kernel)} is not (3, 1|3, 1|3)")
    k2 = ky * kx
    b, q = start.shape
    if q % k2:
        raise ValueError(f"zwin_conv: start {tuple(start.shape)} is not (B, M*{k2})")
    m = q // k2
    oy, ox = (3 - ky) // 2, (3 - kx) // 2
    place = [(oy + j // kx) * 3 + ox + j % kx for j in range(k2)]
    s9 = torch.full((b, m, 9), n, dtype=start.dtype, device=start.device)
    p9 = torch.zeros((b, m, 9), dtype=pattern.dtype, device=pattern.device)
    s9[..., place] = start.reshape(b, m, k2)
    p9[..., place] = pattern.reshape(b, m, k2)
    cin, cout = weight.shape[0] // (kz * k2), weight.shape[1]
    w27 = weight.new_zeros((3, 9, cin, cout))
    w27[:, place] = weight.reshape(kz, k2, cin, cout)
    return s9.reshape(b, m * 9), p9.reshape(b, m * 9), w27.reshape(27 * cin, cout)


def zwin_conv(feats, start, pattern, weight, kernel=(3, 3, 3),
              compute_dtype=torch.float32, route=None):
    """feats (B, N, C); start, pattern (B, M*K2) int32 from
    ``sp.zwin_rulebook``; weight (K*C, Cout). Returns (B, M, Cout) f32.
    Inputs are rounded to ``compute_dtype`` (float32 or bfloat16); sums
    are float32. ``route`` (card only) forces a kernel where the
    comparisons need both; by default ``route_of`` picks it. The kernel
    runs (3, 3, 3); on the card a (3, 1, 1) conv (SECOND's and
    ``VoxelBackBone8x``'s last strided conv, sparse where
    ``dense_from_stage`` is 4) runs as one (``embed_333``)."""
    if feats.device.type == "cpu":
        return sp.conv_zwin_apply(feats, start, pattern, weight, kernel,
                                  compute_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"zwin_conv: unsupported device {feats.device}")
    if tuple(kernel) != (3, 3, 3):
        start, pattern, weight = embed_333(start, pattern, weight, kernel, feats.shape[1])
    if compute_dtype not in _DTYPES:
        raise TypeError(f"zwin_conv: compute_dtype {compute_dtype} unsupported")
    for name, t in (("start", start), ("pattern", pattern), ("weight", weight)):
        if t.device != feats.device:
            raise ValueError(f"zwin_conv: {name} on {t.device}, feats on {feats.device}")
    if feats.dim() != 3 or start.dim() != 2 or start.shape != pattern.shape:
        raise ValueError("zwin_conv: need feats (B, N, C) and start, pattern (B, M*9)")
    b, n, c = feats.shape
    if start.shape[0] != b or start.shape[1] % 9:
        raise ValueError(f"zwin_conv: start {tuple(start.shape)} vs feats {tuple(feats.shape)}")
    if start.dtype != torch.int32 or pattern.dtype != torch.int32:
        raise TypeError("zwin_conv: start and pattern must be int32")
    if weight.dim() != 2 or weight.shape[0] != 27 * c:
        raise ValueError(f"zwin_conv: weight {tuple(weight.shape)} is not (27*{c}, Cout)")
    cout = weight.shape[1]
    if cout not in _COUTS:
        raise ValueError(f"zwin_conv: Cout {cout} not in {_COUTS}")
    if not (feats.is_contiguous() and start.is_contiguous()
            and pattern.is_contiguous()):
        raise ValueError("zwin_conv: feats, start and pattern must be contiguous")
    route = pick_route("zwin_conv", compute_dtype, c, cout, route)
    m = start.shape[1] // 9
    x = feats.to(compute_dtype)
    w = weight.to(compute_dtype).contiguous()
    if route == "mma":
        x, w = aligned16(x), aligned16(w)
    out = torch.empty((b, m, cout), dtype=torch.float32, device=feats.device)
    if b == 0 or m == 0:
        return out
    with torch.cuda.device(feats.device):
        kernels.launch(
            "zwin_conv", _ARGTYPES,
            x.data_ptr(), start.data_ptr(), pattern.data_ptr(), w.data_ptr(),
            out.data_ptr(), b, n, m, c, cout, _DTYPES[compute_dtype],
            ROUTES.index(route), torch.cuda.current_stream().cuda_stream,
            route=route)
    return out


# ---------------------------------------------------------------------------
# The two variants on gathered windows (kernel (3, 3, 3) only).
# ---------------------------------------------------------------------------

_KZ, _K2 = 3, 9
PAIRS = [(dz, j) for dz in range(_KZ) for j in range(dz + 1)]
_ALIGN_COUTS = (16, 32, 64)
_ALIGN_ARGTYPES = [_VP] * 4 + [_CI] * 6 + [_VP]


def gather_windows_km(feats, start, compute_dtype):
    """The window gather of ``conv_zwin_apply_pallas`` / ``_pallas3``:
    feats (B, N, C), start (B, M*9) site-major -> g_km (B, 9, M, 3*C) in
    the compute dtype, window (b, k2, m) holding rows start .. start+2
    (rows >= N read as zero)."""
    b, n, c = feats.shape
    m = start.shape[1] // _K2
    fz = torch.cat([feats, feats.new_zeros((b, _KZ, c))], dim=1).to(compute_dtype)
    zwin = torch.cat([fz[:, dz: n + 1 + dz] for dz in range(_KZ)], dim=-1)
    start_km = start.reshape(b, m, _K2).transpose(1, 2).reshape(b, _K2 * m).long()
    g = torch.gather(zwin, 1, start_km[..., None].expand(b, _K2 * m, _KZ * c))
    return g.reshape(b, _K2, m, _KZ * c)


def _tap_candidates(pat):
    """Per tap dz: (bit dz of the pattern, the candidate index it reads)."""
    bits = [(pat >> dz) & 1 for dz in range(_KZ)]
    jof = [sum(bits[:dz]) if dz else torch.zeros_like(pat) for dz in range(_KZ)]
    return bits, jof


def pair_masks(pattern, m, dtype):
    """v1 masks (B, 9, M, 6): entry (dz, j) set iff bit dz of the window's
    pattern is set and j lower bits are (``zwin_conv.py:366-374``)."""
    b = pattern.shape[0]
    pat = pattern.reshape(b, m, _K2).transpose(1, 2)
    bits, jof = _tap_candidates(pat)
    return torch.stack([(bits[dz] > 0) & (jof[dz] == j) for dz, j in PAIRS],
                       dim=-1).to(dtype).contiguous()


def shift_masks(pattern, m, dtype):
    """v3 masks (3, B, M, 27): entry [s, b, m, k2*3 + j] set iff candidate j
    feeds tap dz = j + s (``zwin_conv.py:329-342``)."""
    b = pattern.shape[0]
    pat = pattern.reshape(b, m, _K2)
    bits, jof = _tap_candidates(pat)
    msks = []
    for s in range(_KZ):
        cols = [(bits[j + s] > 0) & (jof[j + s] == j) if j + s < _KZ
                else torch.zeros_like(pat, dtype=torch.bool) for j in range(_KZ)]
        msks.append(torch.stack(cols, dim=-1).reshape(b, m, _K2 * _KZ))
    return torch.stack(msks, dim=0).to(dtype).contiguous()


def _w_k2_major(weight, c):
    """(27*C, Cout) with taps (dz, k2)-major -> (9, 3, C, Cout) float32."""
    return weight.float().reshape(_KZ, _K2, c, -1).transpose(0, 1)


def zwin_align_gemm_v1_plain(g_km, masks, weight):
    """Plain version of ``zwin_align_gemm_v1``, as the TPU kernel writes it
    (``zwin_conv.py:35``): per (k2, dz) the mask-weighted sum over the
    candidates j <= dz, rounded to the inputs' dtype, then one GEMM."""
    b, k2, m, kzc = g_km.shape
    c = kzc // _KZ
    g = g_km.float().reshape(b, k2, m, _KZ, c)
    mk = masks.float()
    cols = []
    for dz in range(_KZ):
        t = sum(g[..., j, :] * mk[..., PAIRS.index((dz, j)), None]
                for j in range(dz + 1))
        cols.append(t)
    x = torch.stack(cols, dim=3).to(g_km.dtype).float()        # (B, K2, M, dz, C)
    x = x.permute(0, 2, 1, 3, 4).reshape(b * m, k2 * _KZ * c)
    w = _w_k2_major(weight.to(g_km.dtype), c).reshape(k2 * _KZ * c, -1)
    return (x @ w).reshape(b, m, -1)


def zwin_align_gemm_v3_plain(g_km, msk, weight):
    """Plain version of ``zwin_align_gemm_v3``, as the TPU kernel writes it
    (``zwin_conv.py:215``) without its lane padding: per shift s the
    windows times their shift mask, against the weights with candidate j
    routed to tap j + s; the three products summed."""
    b, k2, m, kzc = g_km.shape
    c = kzc // _KZ
    x = g_km.float().reshape(b, k2, m, _KZ, c).permute(0, 2, 1, 3, 4)
    w = _w_k2_major(weight.to(g_km.dtype), c)                  # (K2, dz, C, Cout)
    out = 0.0
    for s in range(_KZ):
        ms = msk[s].float().reshape(b, m, k2, _KZ, 1)
        wshift = torch.zeros_like(w)
        wshift[:, : _KZ - s] = w[:, s:]                        # row j <- tap j + s
        out = out + (x * ms).reshape(b * m, k2 * kzc) @ wshift.reshape(k2 * kzc, -1)
    return out.reshape(b, m, -1)


def _zwin_align(name, plain, g_km, masks, weight, mask_shape, route):
    if g_km.device.type == "cpu":
        return plain(g_km, masks, weight)
    if g_km.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g_km.device}")
    if g_km.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {g_km.dtype} unsupported")
    for what, t in (("masks", masks), ("weight", weight)):
        if t.device != g_km.device:
            raise ValueError(f"{name}: {what} on {t.device}, g_km on {g_km.device}")
    if masks.dtype != g_km.dtype:
        raise TypeError(f"{name}: masks are {masks.dtype}, g_km is {g_km.dtype}")
    if g_km.dim() != 4 or g_km.shape[1] != _K2 or g_km.shape[3] % _KZ:
        raise ValueError(f"{name}: g_km {tuple(g_km.shape)} is not (B, 9, M, 3*C)")
    b, _, m, kzc = g_km.shape
    c = kzc // _KZ
    if tuple(masks.shape) != mask_shape(b, m):
        raise ValueError(f"{name}: masks {tuple(masks.shape)} are not {mask_shape(b, m)}")
    if weight.dim() != 2 or weight.shape[0] != _KZ * _K2 * c:
        raise ValueError(f"{name}: weight {tuple(weight.shape)} is not (27*{c}, Cout)")
    cout = weight.shape[1]
    if cout not in _ALIGN_COUTS:
        raise ValueError(f"{name}: Cout {cout} not in {_ALIGN_COUTS}")
    if not (g_km.is_contiguous() and masks.is_contiguous()):
        raise ValueError(f"{name}: g_km and masks must be contiguous")
    route = pick_route(name, g_km.dtype, c, cout, route)
    w = weight.to(g_km.dtype).contiguous()
    if route == "mma":
        g_km, w = aligned16(g_km), aligned16(w)
    out = torch.empty((b, m, cout), dtype=torch.float32, device=g_km.device)
    if b == 0 or m == 0:
        return out
    with torch.cuda.device(g_km.device):
        kernels.launch(
            name, _ALIGN_ARGTYPES,
            g_km.data_ptr(), masks.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, m, c, cout, _DTYPES[g_km.dtype], kernels.ROUTES[name].index(route),
            torch.cuda.current_stream().cuda_stream, route=route)
    return out


def zwin_align_gemm_v1(g_km, masks, weight, route=None):
    """g_km (B, 9, M, 3*C) gathered windows, k2-major, float32 or
    bfloat16; masks (B, 9, M, 6) of the same dtype, (dz, j) pairs; weight
    (27*C, Cout), rounded to that dtype. Returns (B, M, Cout) f32.
    ``route`` (card only) forces a kernel where the comparisons need both;
    by default ``route_of`` picks it."""
    return _zwin_align("zwin_align_v1", zwin_align_gemm_v1_plain, g_km, masks,
                       weight, lambda b, m: (b, _K2, m, len(PAIRS)), route)


def zwin_align_gemm_v3(g_km, msk, weight, route=None):
    """As ``zwin_align_gemm_v1`` with shift masks msk (3, B, M, 27)."""
    return _zwin_align("zwin_align_v3", zwin_align_gemm_v3_plain, g_km, msk,
                       weight, lambda b, m: (_KZ, b, m, _K2 * _KZ), route)


def _check_zwin_args(name, feats, start, pattern, kernel, compute_dtype):
    if tuple(kernel) != (_KZ, 3, 3):
        raise ValueError(f"{name} supports kernel (3, 3, 3) only, got {kernel}")
    if compute_dtype not in _DTYPES:
        raise TypeError(f"{name}: compute_dtype {compute_dtype} unsupported")
    if (feats.dim() != 3 or start.shape != pattern.shape or start.dim() != 2
            or start.shape[0] != feats.shape[0] or start.shape[1] % _K2):
        raise ValueError(f"{name}: need feats (B, N, C) and start, pattern (B, M*9)")


def conv_zwin_apply_v1(feats, start, pattern, weight, kernel=(3, 3, 3),
                       compute_dtype=torch.bfloat16):
    """The contract of ``zwin_conv`` through the v1 kernel: window gather
    and pair masks in plain PyTorch, then ``zwin_align_gemm_v1``
    (``conv_zwin_apply_pallas``, ``zwin_conv.py:347``)."""
    _check_zwin_args("conv_zwin_apply_v1", feats, start, pattern, kernel,
                     compute_dtype)
    m = start.shape[1] // _K2
    return zwin_align_gemm_v1(gather_windows_km(feats, start, compute_dtype),
                              pair_masks(pattern, m, compute_dtype), weight)


def conv_zwin_apply_v3(feats, start, pattern, weight, kernel=(3, 3, 3),
                       compute_dtype=torch.bfloat16):
    """The contract of ``zwin_conv`` through the v3 kernel: window gather
    and shift masks in plain PyTorch, then ``zwin_align_gemm_v3``
    (``conv_zwin_apply_pallas3``, ``zwin_conv.py:302``)."""
    _check_zwin_args("conv_zwin_apply_v3", feats, start, pattern, kernel,
                     compute_dtype)
    m = start.shape[1] // _K2
    return zwin_align_gemm_v3(gather_windows_km(feats, start, compute_dtype),
                              shift_masks(pattern, m, compute_dtype), weight)
