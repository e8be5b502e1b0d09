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
  the JAX op;
* the card's backward arithmetic, emulated in numpy: every product of the
  CUDA backward kernels is taken as three TF32 products (``cvt.rna.tf32``
  splits of each f32 operand), accumulated as the tensor core does
  (truncating toward zero) in the kernels' order, and dQ, dK and dV so
  computed must stay within 1e-5 of each gradient's max against the
  port's plain f32 versions and within 5e-5 against the JAX kernels;
* the card's forward arithmetic, emulated the same way (q split once,
  S with the small terms apart, the online softmax with exp2, each
  32-key pass of P V in a fresh truncating accumulator): O and lse
  within atol = rtol = 2e-5 of the plain forward and the JAX kernel,
  on the edge and causal cases, including rows that see no key.

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


def _tf32(x):
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, to nearest
    with ties away from zero (0x1000 added to the bit pattern, the low 13
    bits cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tc_read(x):
    """What the tensor core reads of an f32 register: its top 19 bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(x):
    """float64 to f32, truncated toward zero, as the tensor core
    accumulates."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _split_matmul(a, b, small_apart=False, pass_rows=None):
    """``a @ b`` (batched) as the CUDA backward takes it: each operand split
    into big = tf32(x) and small = x - big; per k-block of 8, the terms
    small·big, big·small and big·big each one mma that adds 8 exact
    products to its f32 accumulator and truncates toward zero; the small
    terms in an accumulator of their own (``small_apart``, the scores), or
    the k-rows in passes of ``pass_rows``, each in a fresh accumulator
    added to the sum in f32 (the second products)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tc_read(a - a_big), _tc_read(b - b_big)
    shape = (*a.shape[:-1], b.shape[-1])
    total = np.zeros(shape, np.float32)
    acc, acc_small = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y, small in ((a_small, b_big, True), (a_big, b_small, True),
                            (a_big, b_big, False)):
            into = acc_small if small and small_apart else acc
            into[...] = _toward_zero(
                into + np.matmul(x[..., ks].astype(np.float64),
                                 y[..., ks, :].astype(np.float64)))
        if pass_rows and (k0 + 8) % pass_rows == 0:
            total += acc
            acc[...] = 0
    return total + acc + acc_small


def _split_backward(q, k, v, do, lse, delta, scale, seq_len, causal, q_off,
                    kv_off):
    """dQ, dK, dV of the CUDA backward kernels' arithmetic, in numpy f32:
    S = (q kᵀ) scale and dP = dO vᵀ, P = exp(S − lse) (0 where masked),
    dS = P (dP − δ) scale, then dS k, dSᵀ q and Pᵀ dO in passes of 32
    rows, every product split."""
    hide = tfa._hidden(q.shape[1], k.shape[1], seq_len, causal, q_off, kv_off,
                       "cpu").numpy()
    s = _split_matmul(q, k.transpose(0, 2, 1), small_apart=True)
    p = np.where(hide, np.float32(0),
                 np.exp(s * np.float32(scale) - lse[..., None]))
    dp = _split_matmul(do, v.transpose(0, 2, 1), small_apart=True)
    ds = p * (dp - delta[..., None]) * np.float32(scale)
    return (_split_matmul(ds, k, pass_rows=32),
            _split_matmul(ds.transpose(0, 2, 1), q, pass_rows=32),
            _split_matmul(p.transpose(0, 2, 1), do, pass_rows=32))


def _jax_backward(q, k, v, do, lse, delta, scale, seq_len, causal, q_off,
                  kv_off):
    """The JAX ``_bwd_dq`` and ``_bwd_dkv`` (interpret mode) on the same
    lse and δ: L zero-padded to the 64-row blocks (padded keys sit past
    ``seq_len``), lse and δ copied across the TPU's 128 lanes, the
    outputs cropped."""
    l = q.shape[1]
    pad = ((0, 0), (0, -l % 64), (0, 0))
    q, k, v, do = (jnp.asarray(np.pad(a, pad)) for a in (q, k, v, do))
    lse, delta = (jnp.asarray(np.broadcast_to(
        np.pad(a, pad[:2])[..., None], (*q.shape[:2], 128)))
        for a in (lse, delta))
    args = (scale, 64, 64, causal, seq_len, True, q_off, kv_off)
    dq = jfa._bwd_dq(q, k, v, do, lse, delta, *args)
    dk, dv = jfa._bwd_dkv(q, k, v, do, lse, delta, *args)
    return [np.asarray(g)[:, :l] for g in (dq, dk, dv)]


# (B·H, L, D, seq_len, causal, q_off, kv_off): a train step's spatial
# attention at 4 heads, a ragged ViT-like length and head dim, and the
# masks with offsets
SPLIT_CASES = [(4, 576, 64, 576, False, 0, 0),
               (4, 197, 48, 197, False, 0, 0),
               (3, 200, 64, 150, True, 7, 40)]


@pytest.mark.parametrize("bh,l,d,seq_len,causal,q_off,kv_off", SPLIT_CASES)
def test_split_tf32_backward_matches_plain_and_jax(bh, l, d, seq_len, causal,
                                                  q_off, kv_off):
    q, k, v, do = _qkv((bh, l, d), seed=l + d, n=4)
    scale = d ** -0.5
    args = (scale, seq_len, causal, q_off, kv_off)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_reference(tq, tk, tv, *args)
    delta = (tdo * o).sum(-1)
    plain = (tfa.flash_bwd_dq_reference(tq, tk, tv, tdo, lse, delta, *args),
             *tfa.flash_bwd_dkv_reference(tq, tk, tv, tdo, lse, delta, *args))
    lse, delta = lse.numpy(), delta.numpy()
    split = _split_backward(q, k, v, do, lse, delta, *args)
    jax_grads = _jax_backward(q, k, v, do, lse, delta, *args)
    # the split is not the plain f32 product: it must differ somewhere
    assert any(not np.array_equal(a, b.numpy())
               for a, b in zip(split, plain))
    for name, got, want, jwant in zip(("dq", "dk", "dv"), split, plain,
                                      jax_grads):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        want = want.numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, f"{name}: split vs plain f32 {err:.3e} of max"
        jerr = np.abs(got - jwant).max() / np.abs(jwant).max()
        assert jerr <= 5e-5, f"{name}: split vs JAX kernel {jerr:.3e} of max"


def _split_forward(q, k, v, scale, seq_len, causal, q_off, kv_off,
                   split_q=True):
    """O and lse of the CUDA forward kernel's arithmetic, in numpy f32: q
    times the scale split once (``split_q=False``: taken as one TF32
    operand, the small part dropped); per 64-key tile S = (q scale) kᵀ as three
    TF32 products with the small terms apart; the online softmax with
    ``ex2`` (exp2 in double) of ``s·log2 e − m_safe·log2 e``; then
    O = O·corr + P V, each 32-key half of P V in a fresh truncating
    accumulator added to O in f32; at the end O·(1/l) and
    lse = m_safe + log l, l ≥ 1e-30."""
    log2e = np.float32(1.4426950408889634)
    bh, lq, d = q.shape
    hide = tfa._hidden(lq, k.shape[1], seq_len, causal, q_off, kv_off,
                       "cpu").numpy()
    qs = q * np.float32(scale)
    if not split_q:
        qs = _tf32(qs)
    m = np.full((bh, lq, 1), -np.inf, np.float32)
    l = np.zeros((bh, lq, 1), np.float32)
    o = np.zeros((bh, lq, d), np.float32)
    for k0 in range(0, k.shape[1], 64):
        kt, vt = k[:, k0:k0 + 64], v[:, k0:k0 + 64]
        s = _split_matmul(qs, kt.transpose(0, 2, 1), small_apart=True)
        s = np.where(hide[:, k0:k0 + 64], np.float32(-np.inf), s)
        m_new = np.maximum(m, s.max(-1, keepdims=True))
        m_safe = np.where(m_new == -np.inf, np.float32(0), m_new)
        with np.errstate(invalid="ignore"):
            corr = np.where(m == -np.inf, np.float32(0), np.exp2(
                ((m - m_safe) * log2e).astype(np.float64)).astype(np.float32))
        neg = (-m_safe * log2e).astype(np.float64)
        p = np.exp2(s.astype(np.float64) * np.float64(log2e) + neg).astype(
            np.float32)
        l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        m = m_new
        o = o * corr
        for h in range(0, kt.shape[1], 32):
            o = o + _split_matmul(p[..., h:h + 32], vt[:, h:h + 32])
    lc = np.maximum(l, np.float32(1e-30))
    o = o * (np.float32(1) / lc)
    m_safe = np.where(m == -np.inf, np.float32(0), m)
    return o, (m_safe + np.log(lc)).squeeze(-1)


# (B·H, L, D, seq_len, causal, q_off, kv_off): the TimeSformer's spatial
# length, ragged lengths and head dims, key padding, the causal masks with
# offsets, 16 rows that see no key, and every row hidden
FWD_SPLIT_CASES = [(2, 576, 64, 576, False, 0, 0),
                   (2, 197, 48, 197, False, 0, 0),
                   (2, 200, 64, 200, False, 0, 0),
                   (2, 200, 32, 150, False, 0, 0),
                   (2, 130, 128, 130, False, 0, 0),
                   (2, 200, 64, 200, True, 0, 16),
                   (2, 192, 48, 192, True, 64, 0),
                   (2, 200, 64, 150, True, 7, 40),
                   (2, 130, 64, 130, True, 0, 300)]


@pytest.mark.parametrize("bh,l,d,seq_len,causal,q_off,kv_off",
                         FWD_SPLIT_CASES)
def test_split_tf32_forward_matches_plain_and_jax(bh, l, d, seq_len, causal,
                                                 q_off, kv_off):
    """The CUDA forward's arithmetic (:func:`_split_forward`) against the
    port's plain f32 forward and the JAX Pallas forward in interpret mode
    (L zero-padded to its 64-row blocks, the padded keys past seq_len):
    O and lse within atol = rtol = 2e-5, as the card's kernel is held."""
    q, k, v = _qkv((bh, l, d), seed=3 * l + d + kv_off)
    scale = d ** -0.5
    args = (scale, seq_len, causal, q_off, kv_off)
    o, lse = _split_forward(q, k, v, *args)
    ro, rlse = tfa.flash_fwd_reference(*map(torch.from_numpy, (q, k, v)),
                                       *args)
    pad = ((0, 0), (0, -l % 64), (0, 0))
    jo, jlse = _jax_fwd(*(np.pad(a, pad) for a in (q, k, v)), *args)
    jo, jlse = np.asarray(jo)[:, :l], np.asarray(jlse)[:, :l, 0]
    assert o.dtype == np.float32 and np.isfinite(o).all()
    visible = ~tfa._hidden(l, l, seq_len, causal, q_off, kv_off,
                           "cpu").numpy().all(-1)
    if visible.any():   # the split is not the plain f32 product
        assert not np.array_equal(o, ro.numpy())
    for name, got, want in (("o", o, ro.numpy()), ("lse", lse, rlse.numpy()),
                            ("o vs JAX", o, jo), ("lse vs JAX", lse, jlse)):
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # rows that see no key: o = 0 and lse = log(1e-30), as on the TPU
    np.testing.assert_array_equal(o[:, ~visible], 0.0)
    np.testing.assert_allclose(lse[:, ~visible], np.log(np.float32(1e-30)),
                               rtol=1e-6)


@pytest.mark.parametrize("bh,l,d,seq_len,causal,q_off,kv_off",
                         FWD_SPLIT_CASES[:3])
def test_split_tf32_forward_of_bf16_inputs_is_f32_accurate(
        bh, l, d, seq_len, causal, q_off, kv_off):
    """The bf16 instantiation (the ``--amp`` path): q, k, v widened from
    bf16 are exact in TF32 and their small terms are skipped, but q·scale
    and P are made in f32 inside the kernel and are split as for f32
    inputs (``flash_fwd.cu`` ``ld_q``, ``flash_tf32.cuh`` ``a_of_c``), so O
    and lse stay within the f32 tolerance of the plain forward on the
    widened inputs, lse of the JAX kernel's (which widens bf16 and computes
    in f32), and O rounded to bf16 at most one bf16 ulp from its bf16 O, in
    at most 1% of the values.  Taking q·scale as one TF32 operand instead
    breaks the f32 tolerance where the scale is not a power of two."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv((bh, l, d), seed=7 * l + d))
    scale = d ** -0.5
    args = (scale, seq_len, causal, q_off, kv_off)
    o, lse = _split_forward(q, k, v, *args)
    ro, rlse = tfa.flash_fwd_reference(*map(torch.from_numpy, (q, k, v)),
                                       *args)
    np.testing.assert_allclose(o, ro.numpy(), **TOL)
    np.testing.assert_allclose(lse, rlse.numpy(), **TOL)
    pad = ((0, 0), (0, -l % 64), (0, 0))
    jo, jlse = _jax_fwd(*(np.pad(a, pad).astype(jnp.bfloat16)
                          for a in (q, k, v)), *args)
    np.testing.assert_allclose(lse, np.asarray(jlse)[:, :l, 0], **TOL)
    ob = torch.from_numpy(o).to(torch.bfloat16).float().numpy()
    jo = np.asarray(jo, np.float32)[:, :l]
    diff = np.abs(ob - jo)                  # O rounded to bf16 on both sides
    assert np.all(diff <= 2.0 ** -7 * np.abs(jo) + 1e-6)   # one bf16 ulp
    assert (diff > 0).mean() <= 1e-2
    if np.log2(scale) % 1:    # at D = 64 the scale 1/8 keeps q·scale exact
        unsplit, _ = _split_forward(q, k, v, *args, split_q=False)
        err = np.abs(unsplit - ro.numpy()) - (
            TOL["atol"] + TOL["rtol"] * np.abs(ro.numpy()))
        assert err.max() > 0, "an unsplit q·scale should miss the f32 bound"
