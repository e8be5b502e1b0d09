"""PyTorch port, the walks of the CUDA depthwise forward and dx kernels on
CPU, against the plain versions and the JAX package.

``csrc/depthwise_fwd.cu`` and ``csrc/depthwise_dx.cu`` run only on the
card, so these tests model them in numpy f32: the walk of
``csrc/depthwise_common.cuh`` (work items of a band of rows by a segment of
columns), the input box each item stages with its halo (zeros outside the
image, as the TMA fills it), each thread's units of rows and columns, the
phase classes of the stride-2 dx, and the order of the f32 fused
multiply-adds of every output (exact products in double, one f32
rounding).  Every output must be written by exactly one unit.  The models are held against:

* the forward: ``fused_depthwise_reference`` and the JAX package's XLA
  composition (what the JAX model runs with ``fused_depthwise="off"``; the
  Pallas kernel cannot be traced by this jax version, see ROADMAP);
* dx: ``depthwise_dx_reference`` and ``jax.vjp``'s dx of that composition.

Cases: k ∈ {3, 5} × stride ∈ {1, 2} × padding {'', 'same', 1, k, k+1} at
C = 13 with odd H/W, under the kernels' own walk (its items halved down to
the thread's unit at these sizes) and under the walk's largest items (the
walk a large image takes), and shapes that one item covers.  Tolerance:
within 1e-5 of the output's max |·| (4.8e-7 measured).
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

# csrc/depthwise_common.cuh: strips of 32 channels; work items of a band of
# rows by a segment of columns, rows halved while the items number fewer
# than 132 * 4
_FEW_ITEMS = 132 * 4
_LARGEST = 1          # a threshold that keeps the largest items
# depthwise_fwd.cu: a unit of 1 output row x 4 columns; items of at most 8
# (k = 5, stride 1) or 4 output rows by 16 columns
_FWD_UNIT = (1, 4)
_FWD_ITEM_COLS = 16
# depthwise_dx.cu: a unit of 1 x U groups of S x S dx pixels (U = 4 at
# stride 1, 2 at stride 2); items of at most 8 x 16 groups
_DX_UNIT = {1: (1, 4), 2: (1, 2)}
_DX_ITEM = (8, 16)


def _cdiv(a, b):
    return -(-a // b)


def _walk(b, rows, cols, max_rows, max_cols, row_unit, col_unit, few):
    """(segments, columns a segment, bands, rows a band), as ``walk``; ``b``
    counts images times strips of 32 channels (one strip at C = 13)."""
    segs = _cdiv(cols, max_cols)
    seg_cols = _cdiv(_cdiv(cols, segs), col_unit) * col_unit
    segs = _cdiv(cols, seg_cols)
    most = max_rows
    while True:
        band_rows = _cdiv(_cdiv(rows, _cdiv(rows, most)), row_unit) * row_unit
        bands = _cdiv(rows, band_rows)
        if b * bands * segs >= few or most // 2 < row_unit:
            return segs, seg_cols, bands, band_rows
        most //= 2


def _stage(img, row0, col0, n_rows, n_cols):
    """The block's shared-memory tile: ``img[row0:, col0:]`` (n_rows x
    n_cols pixels), zero outside the image."""
    h, w, c = img.shape
    out = np.zeros((n_rows, n_cols, c), np.float32)
    r0, r1 = max(row0, 0), min(row0 + n_rows, h)
    c0, c1 = max(col0, 0), min(col0 + n_cols, w)
    if r0 < r1 and c0 < c1:
        out[r0 - row0:r1 - row0, c0 - col0:c1 - col0] = img[r0:r1, c0:c1]
    return out


def _fma(acc, a, wv):
    """acc + a · wv with one f32 rounding (the product is exact in f64)."""
    return (acc.astype(np.float64) + a.astype(np.float64) * wv).astype(
        np.float32)


def _write(out, seen, b, h, w, val):
    assert not seen[b, h, w], ("written twice", b, h, w)
    seen[b, h, w] = True
    out[b, h, w] = val


def _fwd_model(x, wt, scale, bias, stride, pads, act, few):
    """y of ``depthwise_fwd.cu``'s walk; returns (y, items an image)."""
    s, k = stride, wt.shape[0]
    bsz, h, w, c = x.shape
    ho, wo = tdw.output_size(h, w, k, s, pads)
    kr, ktw = _FWD_UNIT
    max_rows = 8 if s == 1 and k == 5 else 4
    segs, seg_cols, bands, band_rows = _walk(bsz, ho, wo, max_rows,
                                             _FWD_ITEM_COLS, kr, ktw, few)
    in_rows, in_cols = (band_rows - 1) * s + k, (seg_cols - 1) * s + k
    y = np.full((bsz, ho, wo, c), np.nan, np.float32)
    seen = np.zeros((bsz, ho, wo), bool)
    for b in range(bsz):
        for band in range(bands):
            for seg in range(segs):
                oh0, ow0 = band * band_rows, seg * seg_cols
                rows, cols = min(band_rows, ho - oh0), min(seg_cols, wo - ow0)
                cu = _cdiv(cols, ktw)
                xs = _stage(x[b], oh0 * s - pads[0], ow0 * s - pads[2],
                            in_rows, in_cols)
                for u in range(_cdiv(rows, kr) * cu):
                    r0, q0 = u // cu * kr, u % cu * ktw
                    acc = np.zeros((kr, ktw, c), np.float32)
                    for q in range((kr - 1) * s + k):
                        win = xs[r0 * s + q, q0 * s:q0 * s + (ktw - 1) * s + k]
                        for i in range(kr):
                            r = q - i * s
                            if not 0 <= r < k:
                                continue
                            for sc in range(k):
                                acc[i] = _fma(acc[i], win[sc::s][:ktw],
                                              wt[r, sc])
                    for i in range(kr):
                        for t in range(ktw):
                            if r0 + i < rows and q0 + t < cols:
                                u_ = acc[i, t] * scale + bias
                                _write(y, seen, b, oh0 + r0 + i, ow0 + q0 + t,
                                       _NP_ACTS[act](u_))
    assert seen.all()
    return y, segs * bands


def _dx_model(dz, wt, x_shape, stride, pads, few):
    """dx of ``depthwise_dx.cu``'s walk; returns (dx, items an image)."""
    s, k = stride, wt.shape[0]
    bsz, h, w, c = x_shape
    d_max = (k - 1) // s
    rp, un = _DX_UNIT[s]
    gr0, gc0 = pads[0] // s, pads[2] // s
    ngr = (h - 1 + pads[0]) // s + 1 - gr0
    ngc = (w - 1 + pads[2]) // s + 1 - gc0
    segs, seg_cols, bands, band_rows = _walk(bsz, ngr, ngc, *_DX_ITEM, rp,
                                             un, few)
    dx = np.full(x_shape, np.nan, np.float32)
    seen = np.zeros(x_shape[:3], bool)
    for b in range(bsz):
        for band in range(bands):
            for seg in range(segs):
                tr, tq = band * band_rows, seg * seg_cols
                rows, cols = min(band_rows, ngr - tr), min(seg_cols, ngc - tq)
                g0, q0g = gr0 + tr, gc0 + tq
                cu = _cdiv(cols, un)
                zs = _stage(dz[b], g0 - d_max, q0g - d_max,
                            band_rows + d_max, seg_cols + d_max)
                for u in range(_cdiv(rows, rp) * cu):
                    gr, gq = u // cu * rp, u % cu * un
                    acc = np.zeros((rp, s, un, s, c), np.float32)
                    for qq in range(rp + d_max):
                        win = zs[gr + qq, gq:gq + un + d_max]
                        for i in range(rp):
                            d = i + d_max - qq
                            if not 0 <= d <= d_max:
                                continue
                            for ph in range(s):
                                r = ph + s * d
                                if r >= k:
                                    continue
                                for pw in range(s):
                                    for e in range(d_max + 1):
                                        sc = pw + s * e
                                        if sc < k:
                                            acc[i, ph, :, pw] = _fma(
                                                acc[i, ph, :, pw],
                                                win[d_max - e:d_max - e + un],
                                                wt[r, sc])
                    for i in range(rp):
                        for ph in range(s):
                            hh = s * (g0 + gr + i) + ph - pads[0]
                            if gr + i >= rows or not 0 <= hh < h:
                                continue
                            for j in range(un):
                                for pw in range(s):
                                    ww = s * (q0g + gq + j) + pw - pads[2]
                                    if gq + j < cols and 0 <= ww < w:
                                        _write(dx, seen, b, hh, ww,
                                               acc[i, ph, j, pw])
    assert seen.all()
    return dx, segs * bands


_NP_ACTS = {"none": lambda u: u, "relu": lambda u: np.maximum(u, 0.0),
            "silu": lambda u: u / (1.0 + np.exp(-u))}
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


def _pads(k, stride, pad, shape):
    pad = {"k": k, "k+1": k + 1}.get(pad, pad)
    return pad, tops.explicit_padding(pad, (k, k), 1, stride, shape[1],
                                      shape[2])


def _check_fwd(k, stride, pad, shape, few, act="silu"):
    seed = 13 * k + 3 * stride + shape[1] + len(str(pad)) + few % 7
    x, w, scale, bias = _inputs(k, shape, seed)
    pad, pads = _pads(k, stride, pad, shape)
    got, items = _fwd_model(x, w, scale, bias, stride, pads, act, few)
    plain = tdw.fused_depthwise_reference(
        *map(torch.from_numpy, (x, w, scale, bias)), stride, pad, act).numpy()
    want = _xla(k, stride, pads, act)(*map(jnp.asarray, (x, w, scale, bias)))
    _close(got, plain, "y vs plain")
    _close(got, want, "y vs jax")
    return items


def _check_dx(k, stride, pad, shape, few):
    seed = 17 * k + 5 * stride + shape[1] + len(str(pad)) + few % 7
    x, w, _, _ = _inputs(k, shape, seed)
    pad, pads = _pads(k, stride, pad, shape)
    one, zero = np.float32(1.0), np.float32(0.0)
    y, vjp = jax.vjp(lambda x_: _xla(k, stride, pads, "none")(
        x_, jnp.asarray(w), one, zero), jnp.asarray(x))
    dz = np.random.default_rng(seed).standard_normal(y.shape).astype(
        np.float32)
    (want,) = vjp(jnp.asarray(dz))
    got, items = _dx_model(dz, w, shape, stride, pads, few)
    plain = tdw.depthwise_dx_reference(torch.from_numpy(dz),
                                       torch.from_numpy(w), shape, stride,
                                       pads, torch.float32).numpy()
    _close(got, plain, "dx vs plain")
    _close(got, want, "dx vs jax.vjp")
    return items


PADS = ["", "same", 1, "k", "k+1"]
ITEMS = {"walk": _FEW_ITEMS, "largest": _LARGEST}


@pytest.mark.parametrize("items", list(ITEMS))
@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_fwd_kernel_walk_matches_plain_and_jax(k, stride, pad, items):
    """The forward kernel's walk at C = 13, 19 x 37 (odd H/W, several bands
    and segments either way), SiLU epilogue with scale and bias."""
    assert _check_fwd(k, stride, pad, (2, 19, 37, 13), ITEMS[items]) > 1


@pytest.mark.parametrize("items", list(ITEMS))
@pytest.mark.parametrize("pad", PADS)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_dx_kernel_walk_matches_plain_and_jax(k, stride, pad, items):
    """The dx kernel's walk at C = 13, 19 x 37: the phase classes, the dz
    box with its halo of (k-1)/stride groups, the groups that start before
    row 0 and the padding beyond k-1 that no crop needs."""
    assert _check_dx(k, stride, pad, (2, 19, 37, 13), ITEMS[items]) > 1


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_fwd_kernel_walk_one_item(k, stride, act):
    """A 4 x 9 image that the largest item covers whole: one item."""
    assert _check_fwd(k, stride, 1, (1, 4, 9, 13), _LARGEST, act) == 1


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_dx_kernel_walk_one_item(k, stride):
    assert _check_dx(k, stride, "same", (1, 4, 9, 13), _LARGEST) == 1


def test_walk_halves_item_rows_at_the_flagship_19x19_stage():
    """At batch 1, 19² x 2304 k = 5 (72 strips), 8-row items make 432 items,
    fewer than 132 * 4: the walk halves them to 4 rows, 720 items."""
    assert _walk(72, 19, 19, 8, 16, 1, 4, _FEW_ITEMS) == (2, 12, 5, 4)
    assert _walk(72, 19, 19, 8, 16, 1, 4, _LARGEST) == (2, 12, 3, 7)


def test_depthwise_dx_cpu_does_not_count_launches():
    """A CPU tensor takes the plain version and counts no launch."""
    before = tdw.depthwise_dx.launches
    dx = tdw.depthwise_dx(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8),
                          (1, 8, 8, 8), 2, (1, 0, 1, 0), torch.bfloat16)
    assert dx.shape == (1, 8, 8, 8) and dx.dtype == torch.bfloat16
    assert tdw.depthwise_dx.launches == before
