"""The port's masked-attention core (cone_tpu_torch/ops/attention.py) on the
CPU, where the wrapper takes the plain PyTorch version.

  * `masked_attention_plain` inside the whole attention module (in-proj,
    core, out-proj) with carried weights, against cone_tpu's
    MultiheadAttention (the reference that tools/bench_attn.py states for
    its Pallas kernel): atol 1e-5 in float32 (fp32 sums in another order),
    self- and cross-attention, a fully masked row, Lq != Lk;
  * the same against the port's own MultiheadAttention: atol 1e-6;
  * the wrapper on CPU tensors returns the plain version without a launch
    and refuses bad dtypes and shapes;
  * the kernel's layout as the wrapper derives it (`block_plan`) and a CPU
    model of its float32 arithmetic (3xTF32) inside the stated tolerance;
  * cone_tpu_torch.tools.bench_attn on the CPU: structure, no device time,
    and the analytic bound of the serving shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cone_tpu.models.transformer import MultiheadAttention as JMultiheadAttention
from cone_tpu_torch.models.transformer import MultiheadAttention
from cone_tpu_torch.ops import attention as at
from cone_tpu_torch.ops import tf32
from cone_tpu_torch.tools import bench_attn
from cone_tpu_torch.utils.device import card_peaks

D, H = 32, 4


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"in_proj": {"kernel": rng.normal(size=(D, 3 * D)).astype(np.float32) * 0.2,
                        "bias": rng.normal(size=3 * D).astype(np.float32) * 0.1},
            "out_proj": {"kernel": rng.normal(size=(D, D)).astype(np.float32) * 0.2,
                         "bias": rng.normal(size=D).astype(np.float32) * 0.1}}


def _case(name, seed=1):
    """(query, key, value, mask) numpy inputs of one scenario."""
    rng = np.random.default_rng(seed)
    b, lq, lk = 3, 12, 12
    if name == "cross":
        lq = 5
    x = rng.normal(size=(b, lk, D)).astype(np.float32)
    query = x if name != "cross" else rng.normal(size=(b, lq, D)).astype(np.float32)
    lens = np.array([lk, 7, 3])
    mask = np.arange(lk)[None] >= lens[:, None]
    if name == "fully_masked_row":
        mask[1] = True
    if name == "no_mask":
        mask = None
    return query, x, x + 0.5, mask


def _port_module(w, query, key, value, mask):
    """in-proj -> masked_attention -> out-proj with the carried weights."""
    wt = torch.from_numpy(w["in_proj"]["kernel"]).T.contiguous()
    bt = torch.from_numpy(w["in_proj"]["bias"])
    q = F.linear(torch.from_numpy(query), wt[:D], bt[:D])
    k = F.linear(torch.from_numpy(key), wt[D : 2 * D], bt[D : 2 * D])
    v = F.linear(torch.from_numpy(value), wt[2 * D :], bt[2 * D :])
    m = None if mask is None else torch.from_numpy(mask)
    core = at.masked_attention(q, k, v, m, H)
    return F.linear(core, torch.from_numpy(w["out_proj"]["kernel"]).T,
                    torch.from_numpy(w["out_proj"]["bias"])).numpy()


CASES = ["self", "cross", "fully_masked_row", "no_mask"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_attention_module(name):
    w = _weights()
    query, key, value, mask = _case(name)
    jq = jnp.asarray(query)
    jk = jq if name != "cross" else jnp.asarray(key)
    want = JMultiheadAttention(D, H).apply(
        {"params": w}, jq, jk, jnp.asarray(value),
        None if mask is None else jnp.asarray(mask))
    got = _port_module(w, query, key, value, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_the_ports_attention_module(name):
    w = _weights()
    mha = MultiheadAttention(D, H, device="cpu").eval()
    mha.load_state_dict({
        "in_proj_weight": torch.from_numpy(w["in_proj"]["kernel"]).T.contiguous(),
        "in_proj_bias": torch.from_numpy(w["in_proj"]["bias"]),
        "out_proj.weight": torch.from_numpy(w["out_proj"]["kernel"]).T.contiguous(),
        "out_proj.bias": torch.from_numpy(w["out_proj"]["bias"])})
    query, key, value, mask = _case(name)
    tq = torch.from_numpy(query)
    tk = tq if name != "cross" else torch.from_numpy(key)
    with torch.no_grad():
        want = mha(tq, tk, torch.from_numpy(value),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(_port_module(w, query, key, value, mask), want, atol=1e-6)


def test_fully_masked_row_attends_uniformly():
    q, k, v, mask = bench_attn.make_inputs(2, 6, 9, D, torch.float32, "cpu", seed=3)
    mask[0] = True
    out = at.masked_attention_plain(q, k, v, mask, H)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0], v[0].mean(0).expand(6, D), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_on_cpu_tensors_is_the_plain_version(dtype):
    q, k, v, mask = bench_attn.make_inputs(3, 5, 11, D, dtype, "cpu", seed=4, min_len=4)
    before = at.masked_attention.launches
    got = at.masked_attention(q, k, v, mask, H)
    assert at.masked_attention.launches == before  # no kernel launch on the CPU
    assert got.dtype == dtype and got.shape == (3, 5, D)
    assert torch.equal(got, at.masked_attention_plain(q, k, v, mask, H))
    if dtype == torch.bfloat16:  # fp32 logits and softmax: within one bf16 rounding or two
        ref = at.masked_attention_plain(q.float(), k.float(), v.float(), mask, H)
        torch.testing.assert_close(got.float(), ref, rtol=0, atol=bench_attn.BF16_ATOL)


@pytest.mark.parametrize("bad,exc", [
    ("float16", TypeError), ("mixed_dtype", TypeError), ("mask_dtype", TypeError),
    ("heads", ValueError), ("rank", ValueError), ("kv_shape", ValueError),
    ("mask_shape", ValueError), ("batch", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc):
    q, k, v, mask = bench_attn.make_inputs(2, 4, 6, D, torch.float32, "cpu")
    h = H
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "mask_dtype":
        mask = mask.float()
    elif bad == "heads":
        h = 5
    elif bad == "rank":
        q = q[0]
    elif bad == "kv_shape":
        v = v[:, :5]
    elif bad == "mask_shape":
        mask = mask[:, :5]
    elif bad == "batch":
        k, v = k[:1], v[:1]
    for fn in (at.masked_attention, at.masked_attention_plain):
        with pytest.raises(exc):
            fn(q, k, v, mask, h)


def test_shared_memory_need_of_the_serving_shape():
    # Q, K and V of a head group as 112 rows each (seven 16-key tiles, zero
    # past key 110), rows of 256 + 16 bytes in their own type: 4 heads in
    # bfloat16, 2 in float32; 32 bytes more for the mask's bits
    for itemsize, heads in ((2, 4), (4, 2)):
        plan = at.block_plan(110, 110, 32, 8, itemsize)
        assert plan["heads_per_block"] == heads and plan["grid"] == (8 // heads, 1)
        assert plan["key_tiles"] == 7
        assert plan["smem_bytes"] == 3 * 112 * 272 + 32 == 91424
        assert 2 * (plan["smem_bytes"] + 1024) <= 233472      # two blocks share an SM
    # float32 keys of width 128 beyond 128 keys: refused before any launch
    assert at.smem_bytes(8, 129, 128, 4, 4) > at.MAX_SMEM_BYTES
    assert at.smem_bytes(8, 128, 128, 4, 4) <= at.MAX_SMEM_BYTES
    assert at.smem_bytes(8, 256, 128, 4, 2) <= at.MAX_SMEM_BYTES


@pytest.mark.parametrize("lq,lk,hd,h,itemsize,heads,grid,tiles,smem", [
    (5, 110, 32, 8, 2, 4, (2, 1), 7, (16 + 224) * 272),        # the decoder's cross-attention
    (5, 113, 32, 8, 2, 4, (2, 1), 8, (16 + 256) * 272),
    (300, 256, 64, 4, 2, 2, (2, 3), 16, (128 + 512) * 272),    # three query chunks
    (17, 15, 16, 8, 2, 8, (1, 1), 4, (32 + 128) * 272),        # width 16: eight heads a block
    (17, 65, 16, 8, 4, 4, (2, 1), 7, (32 + 224) * 272),
    (9, 100, 128, 4, 4, 1, (4, 1), 7, (16 + 224) * 528),       # one head wider than 256 bytes
    (12, 12, 16, 3, 2, 3, (1, 1), 4, (16 + 128) * 112),        # fewer heads than would fit
])
def test_block_plan(lq, lk, hd, h, itemsize, heads, grid, tiles, smem):
    plan = at.block_plan(lq, lk, hd, h, itemsize)
    # rows of the head group's bytes + 16, and 32 bytes of mask bits in front
    assert plan == dict(heads_per_block=heads, grid=grid, key_tiles=tiles,
                        smem_bytes=smem + 32)
    assert plan["grid"][0] * heads >= h and smem % 16 == 0   # rows stay 16-byte aligned


@pytest.mark.parametrize("case", ["serving", "fully_masked_row", "large_logits"])
def test_3xtf32_attention_stays_inside_the_float32_tolerance(case):
    # the float32 kernel's arithmetic (both products as three TF32 products,
    # scale applied to the fp32 logits) at the serving shape's L and head
    # width, against the plain version in float64
    q, k, v, mask = bench_attn.make_inputs(6, 110, 110, 256, torch.float32, "cpu", seed=5)
    if case == "fully_masked_row":
        mask[1] = True
    elif case == "large_logits":
        q, k = 3 * q, 3 * k       # logits of std 9: a sharp softmax
    h, hd = 8, 32

    def split(x):
        return x.reshape(6, 110, h, hd).transpose(1, 2)

    logits = tf32.matmul_3xtf32(split(q), split(k).transpose(-1, -2)) * hd ** -0.5
    logits = logits.masked_fill(mask[:, None, None, :], at.NEG_INF)
    got = tf32.matmul_3xtf32(torch.softmax(logits, -1), split(v)).transpose(1, 2).reshape(6, 110, 256)
    want = _plain_f64(q, k, v, mask, h)

    err = float((got.double() - want).abs().max())
    assert err <= bench_attn.F32_REL_TOL * max(1.0, float(want.abs().max())) / 4
    # one TF32 product alone would not do
    one = (tf32.round_tf32(split(q)) @ tf32.round_tf32(split(k)).transpose(-1, -2)) * hd ** -0.5
    one = torch.softmax(one.masked_fill(mask[:, None, None, :], at.NEG_INF), -1)
    one = (tf32.round_tf32(one) @ tf32.round_tf32(split(v))).transpose(1, 2).reshape(6, 110, 256)
    assert float((one.double() - want).abs().max()) > bench_attn.F32_REL_TOL * max(
        1.0, float(want.abs().max()))


def _plain_f64(q, k, v, mask, h):
    b, l, d = q.shape

    def split(x):
        return x.double().reshape(b, x.shape[1], h, d // h).transpose(1, 2)

    logits = (split(q) * (d // h) ** -0.5) @ split(k).transpose(-1, -2)
    logits = logits.masked_fill(mask[:, None, None, :], at.NEG_INF)
    return (torch.softmax(logits, -1) @ split(v)).transpose(1, 2).reshape(b, l, d)


def test_bench_attn_on_the_cpu_reports_no_device_time(capsys):
    out = bench_attn.run(device="cpu", seed=0, shape=(4, 12, D, H))
    assert out["device"] == "cpu" and out["shapes"] == [4, 12, D, H]
    for name in ("float32", "bfloat16"):
        r = out["results"][name]
        assert r["max_abs_err"] == 0.0 and r["ms"] is None and r["plain_ms"] is None
        assert r["library_ms"] is None
    bench_attn.main(["--device", "cpu", "--shape", "2", "6", str(D), str(H)])
    assert '"metric": "attn_kernel_vs_plain"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_attn.run()  # the default device is the card


def test_bench_attn_bound_of_the_serving_shape():
    b, l, d, h = bench_attn.SHAPE
    peaks = card_peaks("NVIDIA H100 80GB HBM3")
    f32 = bench_attn.bound_ms(b, l, l, d, h, torch.float32, peaks)
    assert f32["bytes"] == 4 * 4 * b * l * d + b * l and f32["flops"] == 4 * b * h * l * l * 32
    assert f32["bound_by"] == "operations"
    np.testing.assert_allclose(f32["bound_ms"], f32["flops"] / 67e12 * 1e3)
    bf16 = bench_attn.bound_ms(b, l, l, d, h, torch.bfloat16, peaks)
    assert bf16["bound_by"] == "bytes"
    np.testing.assert_allclose(bf16["bound_ms"], bf16["bytes"] / 3.35e12 * 1e3)
    # the library yardstick computes the same function
    q, k, v, mask = bench_attn.make_inputs(2, 7, 7, D, torch.float32, "cpu", min_len=3)
    mask[1] = True
    torch.testing.assert_close(bench_attn.sdpa(q, k, v, mask, H),
                               at.masked_attention_plain(q, k, v, mask, H),
                               rtol=0, atol=1e-5)
