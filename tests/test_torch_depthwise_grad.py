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
* ``depthwise_backward``, the glue the CUDA autograd node runs (epilogue
  cotangents, dz dilation, dx padding), with the plain versions of its two
  device ops passed in, gives autograd's gradients.

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
    """``depthwise_backward`` with ``plain_conv`` and the plain dw gradient
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
                                     tdw.plain_conv,
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
    ho = tdw.output_size(h, h, k, stride, pads)[0]
    t, b, l, r = tdw.dx_padding(h, h, k, stride, pads, ho, ho)
    dilated = (ho - 1) * stride + 1
    assert tdw.output_size(dilated, dilated, k, 1, (t, b, l, r)) == (h, h)
    assert min(t, b, l, r) >= 0


def test_dx_padding_rejects_padding_beyond_k_minus_1():
    with pytest.raises(ValueError, match="exceeds k-1"):
        tdw.dx_padding(10, 10, 3, 1, (3, 3, 3, 3), 12, 12)


@pytest.mark.parametrize("pads", [(3, 3, 3, 3), (4, 4, 4, 4), (3, 4, 4, 3),
                                  (0, 4, 4, 1)])
@pytest.mark.parametrize("epilogue", ["identity", "affine_silu"])
@pytest.mark.parametrize("stride", [1, 2])
def test_backward_glue_beyond_k_minus_1_matches_jax_vjp(stride, epilogue,
                                                        pads):
    """Padding k and k+1 a side at k = 3 (and mixed sides): the glue with
    the plain device ops, which crops dx out of a correlation padded by at
    most k-1, against ``jax.vjp`` of the XLA composition, whose backward
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
                                 stride, pads, act, tdw.plain_conv,
                                 tdw.depthwise_dwgrad_reference)
    names = ("dx", "dw", "dscale", "dbias") if affine else ("dx", "dw")
    for name, a, b in zip(names, got, want):
        _close(a.numpy(), b, name)
