"""PyTorch port, the fused depthwise backward on CPU against the JAX package.

The JAX reference is ``jax.vjp`` of the XLA composition of the same
function (grouped ``lax.conv_general_dilated`` + affine + act), which is
what the JAX model computes with ``fused_depthwise="off"`` and what
``tests/test_torch_ops.py`` holds the forward to.  (The JAX package's
Pallas kernel cannot be traced by this jax version; see ROADMAP.)

* The plain backward: ``torch.autograd`` through ``fused_depthwise`` on CPU
  tensors (its plain PyTorch version) gives dx, dw, dscale and dbias.
* ``depthwise_dwgrad_reference`` (the dw-gradient kernel's plain version)
  gives JAX's dw.
* ``depthwise_dx_reference`` (the dx kernel's plain version: dilation,
  flipped-kernel correlation, crop) gives autograd's and JAX's dx at x's
  size, also for padding beyond k-1.
* ``depthwise_backward``, the glue the CUDA autograd node runs (epilogue
  cotangents), with the plain versions of its two device ops passed in,
  gives autograd's gradients.
* A numpy model of the CUDA dw-gradient kernel's partition and summation
  order gives the plain version's and JAX's dw.

Inputs are seeded numpy, f32, unit scale.  Tolerance: each gradient within
1e-5 of its own max |·| (f32 sums of a few hundred products taken in
different orders; 4e-7 was measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deepfake_detection_tpu_torch import ops as tops
from deepfake_detection_tpu_torch.ops import depthwise as tdw

torch.set_num_threads(2)

RTOL = 1e-5
SHAPES = [(2, 13, 11, 13), (2, 16, 16, 24)]
_JACTS = {"none": lambda u: u, "relu": lambda u: jnp.maximum(u, 0.0),
          "silu": jax.nn.silu}


def _xla(k, stride, pads, act):
    t, b, l, r = pads

    def f(x, w, scale, bias):
        c = x.shape[-1]
        z = lax.conv_general_dilated(
            x, w.reshape(k, k, 1, c), (stride, stride), [(t, b), (l, r)],
            feature_group_count=c, dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return _JACTS[act](z * scale + bias)
    return f


def _inputs(k, shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal((k, k, c)) * 0.2).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.uniform(-0.2, 0.2, c).astype(np.float32))


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "silu", "relu"])
@pytest.mark.parametrize("pad", ["", "same", 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_plain_backward_matches_jax_vjp(k, stride, pad, act, shape):
    """dx, dw, dscale, dbias of the port's CPU path (autograd through the
    plain version) against ``jax.vjp`` of the XLA composition."""
    seed = k * 1000 + stride * 100 + shape[1] * 3 + len(act)
    x, w, scale, bias = _inputs(k, shape, seed)
    pads = tops.explicit_padding(pad, (k, k), 1, stride, shape[1], shape[2])
    y, vjp = jax.vjp(_xla(k, stride, pads, act), *map(jnp.asarray,
                                                      (x, w, scale, bias)))
    g = np.random.default_rng(seed + 1).standard_normal(y.shape).astype(
        np.float32)
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, bias)]
    out = tops.fused_depthwise(*ts, stride=stride, padding=pad, act=act)
    _close(out.detach().numpy(), y, "y")
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw", "dscale", "dbias"), got, want):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("pad", ["", "same", 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_dwgrad_reference_matches_jax_dw(k, stride, pad):
    """The dw-gradient kernel's plain version against JAX's dw at the
    identity epilogue, where dz is the cotangent itself."""
    shape = SHAPES[0] if stride == 1 else SHAPES[1]
    seed = 7 * k + stride
    x, w, _, _ = _inputs(k, shape, seed)
    pads = tops.explicit_padding(pad, (k, k), 1, stride, shape[1], shape[2])
    one, zero = np.float32(1.0), np.float32(0.0)
    y, vjp = jax.vjp(lambda w_: _xla(k, stride, pads, "none")(
        jnp.asarray(x), w_, one, zero), jnp.asarray(w))
    dz = np.random.default_rng(seed).standard_normal(y.shape).astype(
        np.float32)
    (want,) = vjp(jnp.asarray(dz))
    got = tdw.depthwise_dwgrad_reference(torch.from_numpy(x),
                                         torch.from_numpy(dz), k, stride,
                                         pads)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "dw")
    # a CPU tensor takes the plain version and counts no launch
    before = tdw.depthwise_dwgrad.launches
    _close(tdw.depthwise_dwgrad(torch.from_numpy(x), torch.from_numpy(dz), k,
                                stride, pads).numpy(), want, "dw (wrapper)")
    assert tdw.depthwise_dwgrad.launches == before


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("epilogue", ["identity", "affine_silu",
                                      "affine_relu", "act_only"])
@pytest.mark.parametrize("pad", ["", "same", 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_backward_glue_with_plain_ops_matches_autograd(k, stride, pad,
                                                       epilogue, shape):
    """``depthwise_backward`` with the plain dx and dw-gradient versions
    (what the CUDA node runs with the kernels) against autograd through the
    plain forward, including the dx padding for asymmetric 'same' and for
    stride 2 with odd H/W, and the z-free identity epilogue."""
    seed = 31 * k + 7 * stride + shape[1] + len(epilogue)
    x, w, scale, bias = _inputs(k, shape, seed)
    affine = epilogue.startswith("affine")
    act = {"identity": "none", "affine_silu": "silu", "affine_relu": "relu",
           "act_only": "silu"}[epilogue]
    xt, wt = torch.from_numpy(x).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_() if affine else None
    bt = torch.from_numpy(bias).requires_grad_() if affine else None
    ins = [t for t in (xt, wt, st, bt) if t is not None]
    y = tdw.fused_depthwise_reference(xt, wt, st, bt, stride, pad, act)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(y.shape)).astype(np.float32))
    want = torch.autograd.grad(y, ins, g)
    pads = tops.explicit_padding(pad, (k, k), 1, stride, shape[1], shape[2])
    with torch.no_grad():
        z = None if epilogue == "identity" else \
            tdw.fused_depthwise_reference(xt, wt, None, None, stride, pad,
                                          "none")
        got = tdw.depthwise_backward(g, xt, wt, st, bt, z, stride, pads, act,
                                     tdw.depthwise_dx_reference,
                                     tdw.depthwise_dwgrad_reference)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for name, a, b in zip(("dx", "dw", "dscale", "dbias"), got, want):
        _close(a.numpy(), b.numpy(), name)


@pytest.mark.parametrize("h,k,stride,pads", [
    (16, 3, 2, (0, 1, 0, 1)),      # TF 'same' at even size, stride 2
    (15, 5, 2, (2, 2, 2, 2)),      # odd size: the last column gets no tap
    (13, 3, 1, (1, 1, 1, 1))])
def test_dx_padding_gives_the_input_size(h, k, stride, pads):
    """The plain dx version pads its correlation so that dx comes out at
    exactly x's size, and agrees with autograd through the plain forward;
    the wrapper takes it for a CPU tensor and counts no launch."""
    _check_plain_dx(h, k, stride, pads)


def test_dx_padding_rejects_padding_beyond_k_minus_1():
    """Beyond k-1 of forward padding the correlation takes at most k-1 a
    side (``_dx_pads`` is negative there) and the plain dx version crops the
    rows and columns that lie in the padding instead: dx at x's size, equal
    to autograd's."""
    assert tdw._dx_pads(10, 10, 3, 1, (3, 3, 3, 3), 14, 14) == (-1, -1, -1,
                                                                 -1)
    _check_plain_dx(10, 3, 1, (3, 3, 3, 3))


def _check_plain_dx(h, k, stride, pads):
    rng = np.random.default_rng(h + k + stride)
    x = torch.from_numpy(rng.standard_normal((2, h, h, 5)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((k, k, 5)) * 0.2).astype(
        np.float32))
    padding = [(pads[0], pads[1]), (pads[2], pads[3])]
    y = tdw.fused_depthwise_reference(x, w, None, None, stride, padding,
                                      "none")
    dz = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32))
    (want,) = torch.autograd.grad(y, x, dz)
    before = tdw.depthwise_dx.launches
    for fn in (tdw.depthwise_dx_reference, tdw.depthwise_dx):
        got = fn(dz, w, tuple(x.shape), stride, pads, torch.float32)
        assert tuple(got.shape) == tuple(x.shape)
        _close(got.numpy(), want.numpy(), "dx")
    assert tdw.depthwise_dx.launches == before


@pytest.mark.parametrize("pads", [(3, 3, 3, 3), (4, 4, 4, 4), (3, 4, 4, 3),
                                  (0, 4, 4, 1)])
@pytest.mark.parametrize("epilogue", ["identity", "affine_silu"])
@pytest.mark.parametrize("stride", [1, 2])
def test_backward_glue_beyond_k_minus_1_matches_jax_vjp(stride, epilogue,
                                                        pads):
    """Padding k and k+1 a side at k = 3 (and mixed sides): the glue with
    the plain device ops, whose dx is cropped out of a correlation padded by
    at most k-1, against ``jax.vjp`` of the XLA composition, whose backward
    pads by k-1 and crops."""
    k, shape = 3, SHAPES[0]
    seed = 97 * stride + sum(pads) + len(epilogue)
    x, w, scale, bias = _inputs(k, shape, seed)
    affine = epilogue == "affine_silu"
    act = "silu" if affine else "none"
    if not affine:
        scale, bias = np.ones_like(scale), np.zeros_like(bias)
    y, vjp = jax.vjp(_xla(k, stride, pads, act), *map(jnp.asarray,
                                                      (x, w, scale, bias)))
    g = np.random.default_rng(seed).standard_normal(y.shape).astype(
        np.float32)
    want = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    st = torch.from_numpy(scale) if affine else None
    bt = torch.from_numpy(bias) if affine else None
    padding = [(pads[0], pads[1]), (pads[2], pads[3])]
    z = None if not affine else tdw.fused_depthwise_reference(
        xt, wt, None, None, stride, padding, "none")
    got = tdw.depthwise_backward(torch.from_numpy(g), xt, wt, st, bt, z,
                                 stride, pads, act,
                                 tdw.depthwise_dx_reference,
                                 tdw.depthwise_dwgrad_reference)
    names = ("dx", "dw", "dscale", "dbias") if affine else ("dx", "dw")
    for name, a, b in zip(names, got, want):
        _close(a.numpy(), b, name)


# The CUDA dw-gradient kernel's partition (csrc/depthwise_dwgrad.cu): strips
# of 32 channels; tiles of (image, band of output rows, segment of at most 32
# output columns) planned to fill about 2 * 132 * 3 blocks, bands of at least
# 8 rows; 4 runs of columns a segment
_CW, _RUNS, _SEG, _TARGET, _MIN_ROWS = 32, 4, 32, 2 * 132 * 3, 8


def _dwgrad_plan(b, ho, wo, c):
    """(segments, columns a segment, bands, rows a band), as ``plan``."""
    strips = -(-c // _CW)
    segs = -(-wo // _SEG)
    seg_cols = -(-wo // segs)
    bands = -(-_TARGET // (strips * b * segs))
    rows = min(max(-(-ho // bands), _MIN_ROWS), ho)
    return segs, seg_cols, -(-ho // rows), rows


def _dwgrad_model(x, dz, k, stride, pads):
    """dw in the kernel's order, in numpy f32: per tile and tap row r, each
    run of output columns walks the band's rows in order and its columns in
    order, a window of the k x values of row ``h·s + r − top`` (zero outside
    x) times dz added by fused multiply-adds (exact products in double, one
    f32 rounding); the runs' sums added in order 0..3, then the tiles' by
    the second pass."""
    b, h, w, c = x.shape
    _, ho, wo, _ = dz.shape
    top, left = pads[0], pads[2]
    segs, seg_cols, bands, rows = _dwgrad_plan(b, ho, wo, c)
    partials = []
    for bi in range(b):
        for band in range(bands):
            for seg in range(segs):
                h0, w0 = band * rows, seg * seg_cols
                ncols = min(seg_cols, wo - w0)
                per = -(-ncols // _RUNS)
                runs = np.zeros((_RUNS, k, k, c), np.float32)
                for hq in range(h0, min(h0 + rows, ho)):
                    for r in range(k):
                        xr = hq * stride - top + r
                        if not 0 <= xr < h:
                            continue
                        for u in range(_RUNS):
                            j1 = min(w0 + (u + 1) * per, w0 + ncols)
                            for j in range(w0 + u * per, j1):
                                g = dz[bi, hq, j].astype(np.float64)
                                for s in range(k):
                                    xc = j * stride - left + s
                                    xv = x[bi, xr, xc] if 0 <= xc < w else 0
                                    runs[u, r, s] = (runs[u, r, s] + g * xv
                                                     ).astype(np.float32)
                tile = np.zeros((k, k, c), np.float32)
                for u in range(_RUNS):
                    tile = tile + runs[u]
                partials.append(tile)
    # the second pass: lane y of 32 adds tiles y, y + 32, ... in order, then
    # the lanes' sums are added in order
    lanes = min(len(partials), 32)
    dw = np.zeros_like(partials[0])
    for y in range(lanes):
        lane = np.zeros_like(dw)
        for tile in partials[y::lanes]:
            lane = lane + tile
        dw = dw + lane
    return dw


@pytest.mark.parametrize("shape", [(2, 19, 37, 13), (1, 7, 9, 13)])
@pytest.mark.parametrize("pad", ["", "same", 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_dwgrad_kernel_partition_matches_plain_and_jax(k, stride, pad, shape):
    """The CUDA dw-gradient kernel's partition and summation order
    (:func:`_dwgrad_model`: bands, segments, tap rows, the halo and the
    stride-2 edges as zeros, the fixed-order sums) against the plain
    version and ``jax.vjp``'s dw, within 1e-5 of dw's max.  C = 13 and odd
    H/W; at (2, 19, 37) stride 1 the 37 output columns make two segments
    and the 19 rows three bands (12 tiles), at (1, 7, 9) one tile, which
    the second pass adds to zero."""
    _check_partition(k, stride, pad, shape)


def test_dwgrad_kernel_partition_more_tiles_than_lanes():
    """54 tiles (3 images × 3 segments × 6 bands): the second pass adds them
    in 32 lanes, then the lanes in order."""
    assert 3 * np.prod(_dwgrad_plan(3, 41, 70, 13)[::2]) == 54
    _check_partition(3, 1, "", (3, 41, 70, 13))


def _check_partition(k, stride, pad, shape):
    seed = 11 * k + 5 * stride + shape[1] + len(str(pad))
    x, _, _, _ = _inputs(k, shape, seed)
    pads = tops.explicit_padding(pad, (k, k), 1, stride, shape[1], shape[2])
    one, zero = np.float32(1.0), np.float32(0.0)
    y, vjp = jax.vjp(lambda w_: _xla(k, stride, pads, "none")(
        jnp.asarray(x), w_, one, zero), jnp.zeros((k, k, shape[3])))
    dz = np.random.default_rng(seed).standard_normal(y.shape).astype(
        np.float32)
    (want,) = vjp(jnp.asarray(dz))
    got = _dwgrad_model(x, dz, k, stride, pads)
    plain = tdw.depthwise_dwgrad_reference(torch.from_numpy(x),
                                           torch.from_numpy(dz), k, stride,
                                           pads).numpy()
    assert got.dtype == np.float32 and got.shape == (k, k, shape[3])
    _close(got, plain, "dw vs plain")
    _close(got, want, "dw vs jax.vjp")
