"""Port vs reference: one-token GQA decode attention (the kernel's plain
version) against ``repro.kernels.ops.decode_attention`` (Pallas, interpret
mode) and ``repro.kernels.ref.decode_attention_ref``.

Tolerance: f32, atol 2e-5 and rtol 1e-5 — the versions sum the same
products in other orders (einsum vs online softmax over key blocks).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.decode_attn import decode_attention_pallas  # noqa: E402
from repro.kernels.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attn as tattn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads per worker: the suite runs several workers on
    shared cores, and more threads only contend with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL, RTOL = 2e-5, 1e-5
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _inputs(B, H, KV, hd, S, kv, seed=0):
    """Same bits on both sides: numpy f32 → bf16 (→ fp8) in each package,
    checked equal byte for byte."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jdt, tdt = DTYPES[kv]
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16).astype(jdt) for a in (k, v))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16).to(tdt) for a in (k, v))
    for j, t in ((jq, tq), (jk, tk), (jv, tv)):
        width = np.int16 if t.element_size() == 2 else np.uint8
        tview = torch.int16 if t.element_size() == 2 else torch.uint8
        np.testing.assert_array_equal(np.asarray(j).view(width),
                                      t.view(tview).numpy())
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("B,H,KV,hd,S,valid", [
    (1, 14, 2, 64, 640, 576),      # qwen2-0.5b decode: GQA group 7
    (2, 14, 2, 64, 200, 200),      # ragged S (not a tile multiple)
    (2, 8, 2, 32, 256, 37),        # valid_len far below S
    (1, 4, 4, 128, 96, 1),         # one valid slot
])
@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_plain_matches_pallas_and_oracle(B, H, KV, hd, S, valid, kv):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, H, KV, hd, S, kv, seed=S + valid)
    got = tattn.decode_attention_plain(tq, tk, tv, valid).numpy()
    if S % min(512, S) == 0:
        pallas = rops.decode_attention(jq, jk, jv, valid_len=valid,
                                       interpret=True)
    else:   # the reference kernel needs key blocks that divide S
        pallas = decode_attention_pallas(jq, jk, jv, valid, block_s=128,
                                         interpret=True)
    pallas = np.asarray(pallas)
    oracle = np.asarray(decode_attention_ref(jq, jk, jv, valid))
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    assert got.dtype == np.float32 and got.shape == (B, H, hd)


def test_prescaled_query_path_matches_scaled_reference():
    """The model's decode step hands the kernel ``bf16(q * scale)`` with
    ``scale=1``: for hd = 64 (scale 1/8, exact) that is the reference
    kernel's own result."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 14, 2, 64, 512, "bf16")
    pre = (tq * torch.tensor(0.125, dtype=torch.bfloat16))
    got = tattn.decode_attention(pre, tk, tv, 300, scale=1.0).numpy()
    ref = np.asarray(rops.decode_attention(jq, jk, jv, valid_len=300,
                                           interpret=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_wrapper_on_cpu_takes_plain_and_validates():
    _, (tq, tk, tv) = _inputs(1, 14, 2, 64, 64, "bf16")
    before = build.LAUNCHES["decode_attn"]
    out = tattn.decode_attention(tq, tk, tv, 10)
    assert build.LAUNCHES["decode_attn"] == before
    assert torch.equal(out, tattn.decode_attention_plain(tq, tk, tv, 10))
    with pytest.raises(TypeError):
        tattn.decode_attention(tq.float(), tk, tv, 10)
    with pytest.raises(TypeError):
        tattn.decode_attention(tq, tk.float(), tv.float(), 10)
    with pytest.raises(ValueError):
        tattn.decode_attention(tq, tk[:, :, :1], tv, 10)
    with pytest.raises(ValueError):
        tattn.decode_attention(tq[:, :13], tk, tv, 10)
