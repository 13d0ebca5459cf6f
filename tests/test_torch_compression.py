"""``repro_torch.train.compression`` against ``repro.train.compression``.

- ``quantize_int8``, ``dequantize_int8`` and ``compress_decompress`` equal
  the reference's bit for bit (codes, scales, outputs, error buffers) on
  float32 and bf16 leaves of sizes that are and are not multiples of
  ``CHUNK``, with and without an error carry, and on zeros (the 1e-12
  scale floor).
- The reference's own checks (``tests/test_train_system.py::
  TestCompression``) on the port.
- ``compressed_psum`` in one spawn of 4 ``gloo`` processes
  (``_torch_dist_workers.task_compression``): the same tree on every rank
  over a 4-rank axis equals the reference's over 4 of the 8 fake CPU
  devices bit for bit; a different tree and error carry per rank over the
  "data" axis of a 2x2 mesh equals a numpy transcription of the
  reference's body (int32 code sum, float32 scale mean, ``q_sum / n``
  dequantized, the local residual) bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as rcomp
from repro_torch.train import compression as comp

import _torch_dist_workers as W
from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

SIZES = [(1,), (5,), (1000,), (1024,), (3000,), (3, 5, 821), (0,)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor, in ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """The float32 bits of a jax array or a tensor (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy().view(np.uint32)
    return np.asarray(x.astype(jnp.float32)).view(np.uint32)


def _values(shape, seed: int) -> np.ndarray:
    """Gradient-like values: three magnitudes, some exact zeros."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1e-3, shape) * rng.choice([1.0, 100.0, 1e-6], shape)
    a.reshape(-1)[:3] = 0.0
    return a.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SIZES, ids=str)
def test_quantize_and_round_trip_match_reference(shape, dtype):
    x = _values(shape, 0)
    jx, tx = _pair(x, dtype)
    q, s = rcomp.quantize_int8(jx)
    tq, ts = comp.quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(q), tq.numpy())
    assert np.array_equal(_bits(s), _bits(ts))
    d = rcomp.dequantize_int8(q, s, jx.shape, jx.dtype)
    td = comp.dequantize_int8(tq, ts, tx.shape, tx.dtype)
    assert td.dtype == tx.dtype and tuple(td.shape) == shape
    assert np.array_equal(_bits(d), _bits(td))
    je, te = _pair(_values(shape, 1) * 0.01, dtype)
    for err in (None, (je, te)):
        out = rcomp.compress_decompress(jx, None if err is None else err[0])
        got = comp.compress_decompress(tx, None if err is None else err[1])
        for a, b in zip(out, got):
            assert b.dtype == tx.dtype
            assert np.array_equal(_bits(a), _bits(b))


def test_zeros_keep_the_scale_floor():
    for dtype in ("float32", "bfloat16"):
        jx, tx = _pair(np.zeros(2 * comp.CHUNK + 7, np.float32), dtype)
        q, s = rcomp.quantize_int8(jx)
        tq, ts = comp.quantize_int8(tx)
        assert np.array_equal(_bits(s), _bits(ts))
        assert float(ts[0, 0]) == np.float32(1e-12)
        assert not tq.any() and not np.asarray(q).any()
        deq, err = comp.compress_decompress(tx)
        assert not deq.any() and not err.any()


# -------- mirror of tests/test_train_system.py::TestCompression, on the port
class TestCompression:
    def test_quantize_roundtrip_error_small(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(0, 1e-3, size=(1000,))
                             .astype(np.float32))
        q, s = comp.quantize_int8(x)
        deq = comp.dequantize_int8(q, s, x.shape, x.dtype)
        rel = float(torch.linalg.norm(deq - x) / torch.linalg.norm(x))
        assert rel < 0.01

    def test_error_feedback_converges(self):
        x = torch.tensor([1e-4, -2e-4, 3e-4] * 100, dtype=torch.float32)
        err = torch.zeros_like(x)
        acc = torch.zeros_like(x)
        for _ in range(50):
            deq, err = comp.compress_decompress(x, err)
            acc = acc + deq
        np.testing.assert_allclose((acc / 50).numpy(), x.numpy(),
                                   rtol=0.02, atol=1e-7)

    def test_compressed_psum_multidevice(self, psum_ranks):
        for r in psum_ranks:
            mean = r["same"][0]["g"]
            np.testing.assert_allclose(mean, 0.5, rtol=0.02)


# ------------------------------------------------------------ four ranks
SAME = {"g": np.full(comp.CHUNK * 2, 0.5, np.float32),
        "w": _values((3, 700), 2),
        "b": _values((1500,), 3).astype(np.float32)}


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16
                                                       ).numpy().view(np.uint16)


def _per_rank():
    """A gradient tree and an error carry per rank; ``b`` in bf16 (its
    uint16 bits)."""
    out = []
    for r in range(4):
        g = {"w": _values((3, 700), 10 + r),
             "b": _bf16_bits(_values((1500,), 20 + r))}
        e = {"w": _values((3, 700), 30 + r) * 0.01,
             "b": _bf16_bits(_values((1500,), 40 + r) * 0.01)}
        out.append({"g": g, "e": e})
    return out


@pytest.fixture(scope="module")
def psum_ranks(tmp_path_factory):
    same = dict(SAME, b=_bf16_bits(SAME["b"]))
    return W.spawn("compression", 4, tmp_path_factory.mktemp("psum"),
                   {"same": same, "per_rank": _per_rank()})


def _f32(a: np.ndarray) -> np.ndarray:
    """float32 values of a stored leaf (bf16 leaves are uint16 bits)."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16
                                                       ).float().numpy()
    return a


def test_same_tree_equals_reference_over_four_devices(psum_ranks):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))
    tree = {"g": jnp.asarray(SAME["g"]), "w": jnp.asarray(SAME["w"]),
            "b": jnp.asarray(SAME["b"]).astype(jnp.bfloat16)}
    mean, err = rcomp.compressed_psum(tree, mesh, "data")
    for r in psum_ranks:
        got_mean, got_err = r["same"]
        for k in tree:
            assert np.array_equal(_bits(mean[k]),
                                  _f32(got_mean[k]).view(np.uint32)), k
            assert np.array_equal(_bits(err[k]),
                                  _f32(got_err[k]).view(np.uint32)), k


def _np_quantize(x: np.ndarray):
    """numpy transcription of ``quantize_int8`` in float32."""
    flat = x.reshape(-1).astype(np.float32)
    flat = np.pad(flat, (0, (-flat.size) % comp.CHUNK))
    chunks = flat.reshape(-1, comp.CHUNK)
    scale = np.max(np.abs(chunks), axis=1, keepdims=True) / np.float32(127)
    scale = np.maximum(scale, np.float32(1e-12))
    q = np.clip(np.round(chunks / scale), -127, 127).astype(np.int8)
    return q, scale


def _np_dequantize(q, scale, shape, bf16: bool) -> np.ndarray:
    flat = (q.astype(np.float32) * scale).reshape(-1)
    out = flat[:int(np.prod(shape))].reshape(shape)
    return _f32(_bf16_bits(out)) if bf16 else out


def test_per_rank_trees_equal_numpy_oracle(psum_ranks):
    """Over "data" of a 2x2 mesh the groups are ranks {0, 2} and {1, 3}
    (same "model" coordinate)."""
    trees = _per_rank()
    for rank, r in enumerate(psum_ranks):
        assert r["coordinate"] == (rank // 2, rank % 2)
        assert r["jax_loaded"] == []
        group = [m for m in range(4) if m % 2 == rank % 2]
        got_mean, got_err = r["per_rank"]
        for k in ("w", "b"):
            bf16 = k == "b"
            qs, ss, mine = [], [], None
            for m in group:
                g, e = _f32(trees[m]["g"][k]), _f32(trees[m]["e"][k])
                target = g + e
                if bf16:  # the sum rounds to the leaf's dtype
                    target = _f32(_bf16_bits(target))
                q, s = _np_quantize(target)
                qs.append(q.astype(np.int32))
                ss.append(s)
                if m == rank:
                    mine = (target, q, s)
            n = len(group)
            q_sum = qs[0] + qs[1]
            s_mean = (ss[0] + ss[1]) / np.float32(n)
            shape = _f32(trees[rank]["g"][k]).shape
            want = _np_dequantize(q_sum.astype(np.float32) / np.float32(n),
                                  s_mean, shape, bf16)
            target, q, s = mine
            want_err = target - _np_dequantize(q, s, shape, bf16)
            if bf16:
                want_err = _f32(_bf16_bits(want_err))
            assert np.array_equal(_f32(got_mean[k]).view(np.uint32),
                                  want.astype(np.float32).view(np.uint32)), k
            assert np.array_equal(_f32(got_err[k]).view(np.uint32),
                                  want_err.astype(np.float32).view(np.uint32))
