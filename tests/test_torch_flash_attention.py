"""PyTorch port, flash attention on CPU against the JAX package's kernels.

The JAX side is ``deepfake_detection_tpu/ops/flash_attention.py``, whose
Pallas kernels run under the interpreter on the CPU, as
``tests/test_flash_attention.py`` runs them.  The port's side is
``deepfake_detection_tpu_torch/ops/flash_attention.py`` on CPU tensors,
which take the plain PyTorch versions of its three CUDA kernels.

* the public ``flash_attention`` forward on that file's cases (L 64, 200,
  256, 320; D 32, 48, 64; causal on and off) and in bf16;
* the three device functions called directly, with ``seq_len < L``,
  nonzero ``q_off``/``kv_off`` and causal rows that see no key, against the
  JAX ``_fwd``, ``_bwd_dq`` and ``_bwd_dkv`` with the same arguments: O, lse
  (the JAX lane copy cropped), dQ, dK, dV;
* gradients through the port's ``autograd.Function`` against ``jax.vjp`` of
  the JAX op.

Inputs are seeded numpy.  Tolerances: atol = rtol = 2e-5 in f32 for the
forward (sums of up to 320 f32 products, blocked differently: 64-row tiles
here, 128 on the TPU side), 3e-2 in bf16 (one bf16 rounding of O), 5e-5 for
gradients (as ``tests/test_flash_attention.py`` holds the JAX kernels to
dense attention).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_detection_tpu_torch.ops import flash_attention as tfa
from deepfake_detection_tpu_torch.parallel.ring_attention import (
    full_attention)

# the JAX ops package re-exports the function under the module's name
jfa = importlib.import_module("deepfake_detection_tpu.ops.flash_attention")

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _qkv(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("l,d,causal", [(64, 32, False), (200, 64, False),
                                        (256, 64, True), (320, 48, True)])
def test_forward_matches_jax(l, d, causal):
    q, k, v = _qkv((2, l, 3, d), seed=l + d)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert got.shape == (2, l, 3, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the port's dense reference agrees with its flash op
    ref = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_bf16_forward_matches_jax():
    q, k, v = _qkv((1, 128, 2, 64), seed=2)
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)))
    got = tfa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


# (L, D, seq_len, causal, q_off, kv_off); the JAX kernels take L in
# 64-row blocks.  kv_off > q_off hides every key from the first rows.
DEVICE_CASES = [
    (128, 32, 100, True, 0, 16),     # rows 0-15 see no key
    (192, 64, 150, False, 0, 0),     # key padding only
    (128, 48, 128, True, 64, 0),     # a later Q shard of a ring
    (128, 64, 90, True, 7, 40),      # padding, offsets, masked rows
]


def _device_inputs(l, d, seed):
    q, k, v, do = _qkv((3, l, d), seed, n=4)
    return q, k, v, do


def _jax_fwd(q, k, v, scale, seq_len, causal, q_off, kv_off):
    return jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                    64, 64, causal, seq_len, True, q_off, kv_off)


@pytest.mark.parametrize("l,d,seq_len,causal,q_off,kv_off", DEVICE_CASES)
def test_device_functions_match_jax(l, d, seq_len, causal, q_off, kv_off):
    q, k, v, do = _device_inputs(l, d, seed=l + d + seq_len)
    scale = d ** -0.5
    args = (scale, seq_len, causal, q_off, kv_off)
    jo, jlse = _jax_fwd(q, k, v, *args)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    o, lse = tfa.flash_fwd(tq, tk, tv, *args)
    assert lse.shape == (3, l) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)
    if causal and kv_off > q_off:      # the rows that see no key
        hidden = kv_off - q_off
        np.testing.assert_array_equal(o[:, :hidden].numpy(), 0.0)
        np.testing.assert_allclose(lse[:, :hidden].numpy(),
                                   np.log(np.float32(1e-30)), rtol=1e-6)

    delta = (tdo * o).sum(-1)
    jdelta = jfa._delta(jnp.asarray(do), jo)
    jdq = jfa._bwd_dq(*map(jnp.asarray, (q, k, v, do)), jlse, jdelta, scale,
                      64, 64, causal, seq_len, True, q_off, kv_off)
    jdk, jdv = jfa._bwd_dkv(*map(jnp.asarray, (q, k, v, do)), jlse, jdelta,
                            scale, 64, 64, causal, seq_len, True, q_off,
                            kv_off)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, *args)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, *args)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


@pytest.mark.parametrize("shape,causal", [((2, 160, 2, 32), False),
                                          ((2, 160, 2, 32), True),
                                          ((1, 197, 3, 64), False)])
def test_grads_match_jax_vjp(shape, causal):
    q, k, v = _qkv(shape, seed=shape[1] + int(causal))
    g = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c,
                                                           causal=causal),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got_out = tfa.flash_attention(*ts, causal=causal)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **TOL)
    got = torch.autograd.grad(got_out, ts, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"d{name}", **GRAD_TOL)


def test_wrappers_reject_other_devices_and_shapes():
    q = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tfa.flash_fwd(q, q, q, 0.25, 8)
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="self-attention"):
        tfa.flash_attention(x, x[:, :4], x[:, :4])
