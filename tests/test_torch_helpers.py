"""The reference's public helpers that no runtime path calls, in the port:
``quant``'s exports, ``QuantizedTensor`` and the input quantizers,
``core.slicing``'s sign-magnitude slicing and its inverse,
``center_offset.decode``, the package re-exports of ``models`` and
``core``, and the ``JAMBA_15_LARGE`` config name. Each is held ``==``
against the reference on the CPU (integer-exact, or float32 operations in
the reference's order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.models as ref_models
import repro.quant as ref_quant
from repro import configs as ref_configs
from repro.core import center_offset as ref_co
from repro.core import slicing as ref_sl
from repro.quant import quantize as ref_q
import repro_torch.core as core
import repro_torch.models as models
import repro_torch.quant as quant
from repro_torch import configs
from repro_torch.core import center_offset as co
from repro_torch.core import slicing as sl
from repro_torch.quant import quantize as q

from _torch_parity import one_thread  # noqa: F401  (autouse fixture)

INT8 = np.arange(-128, 128, dtype=np.int8)
U8 = np.arange(0, 256, dtype=np.int32)


def test_quant_exports_the_references_names():
    assert quant.__all__ == ref_quant.__all__
    for name in ref_quant.__all__:
        assert hasattr(quant, name), name


def test_quantized_tensor_fields():
    assert [f.name for f in dataclasses.fields(quant.QuantizedTensor)] == \
        [f.name for f in dataclasses.fields(ref_quant.QuantizedTensor)]
    qt = quant.QuantizedTensor(torch.zeros(3, dtype=torch.int32),
                               torch.ones(()),
                               torch.zeros((), dtype=torch.int32), True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        qt.signed = False


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("top", ["scalar", "array", "tiny"])
def test_quantize_inputs_match_reference(signed, top):
    """Codes and scale ``==`` the reference's on float32 inputs (rounding
    half to even on exact ties included), and on bf16 inputs, which both
    promote to float32."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 33)).astype(np.float32) * 3
    if not signed:
        x = np.abs(x)
    bound = {"scalar": float(np.abs(x).max()),
             "array": np.float32(np.abs(x).max() * 0.7),
             "tiny": 0.0}[top]
    x[0, :4] = [0.5, 1.5, 2.5, -0.5 if signed else 3.5]  # ties
    ref_fn = ref_q.quantize_inputs_signed if signed \
        else ref_q.quantize_inputs_unsigned
    fn = q.quantize_inputs_signed if signed else q.quantize_inputs_unsigned
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        got, scale = fn(xt, bound)
        xj = jnp.asarray(xt.to(torch.float32).numpy(),
                         jnp.float32 if dt == torch.float32 else jnp.bfloat16)
        want, want_scale = ref_fn(xj, bound)
        assert got.dtype == torch.int32 and scale.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(scale) == float(want_scale)


def test_crop_and_slice_signed_every_slicing():
    """Every int8 value under each of the 108 slicings: the signed and
    unsigned slices, their reconstruction and the 1b re-slicing of each
    slice equal the reference's."""
    x = torch.from_numpy(INT8)
    u = torch.from_numpy(U8)
    assert sl.np_enumerate_slicings_count() == \
        ref_sl.np_enumerate_slicings_count() == 108
    for slicing in ref_sl.enumerate_slicings():
        got = sl.slice_signed(x, slicing)
        want = ref_sl.slice_signed(INT8, slicing)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            sl.reconstruct(got, slicing).numpy(),
            np.asarray(ref_sl.reconstruct(want, slicing)))
        gu = sl.slice_unsigned(u, slicing)
        wu = ref_sl.slice_unsigned(U8, slicing)
        for g, w in zip(gu, wu):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(sl.reconstruct(gu, slicing).numpy(),
                                      U8)
        for g, w, width in zip(got, want, slicing):
            for a, b in zip(sl.reslice_to_1b(g, width),
                            ref_sl.reslice_to_1b(w, width)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("h,l", [(7, 0), (7, 4), (3, 2), (0, 0), (6, 6)])
def test_crop_signed_matches_reference(h, l):
    np.testing.assert_array_equal(
        sl.crop_signed(torch.from_numpy(INT8), h, l).numpy(),
        np.asarray(ref_sl.crop_signed(INT8, h, l)))


def test_to_unsigned_weights():
    got = sl.to_unsigned_weights(torch.from_numpy(INT8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_sl.to_unsigned_weights(INT8)))
    np.testing.assert_array_equal(got.numpy(), U8)


@pytest.mark.parametrize("mode", ["center", "zero", "unsigned"])
@pytest.mark.parametrize("slicing", [(4, 4), (2, 2, 2, 2), (3, 1, 4)])
def test_center_offset_decode(mode, slicing):
    """``decode`` of the port's encoding equals the reference's ``decode``
    of its own, and the weights (exact for Center+Offset: 640 rows, two
    segments, the second padded)."""
    rng = np.random.default_rng(2)
    w = rng.integers(0, 256, (640, 12)).astype(np.int32)
    got = co.decode(co.encode(torch.from_numpy(w), slicing, mode=mode))
    want = ref_co.decode(ref_co.encode(w, slicing, mode=mode))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "center":
        np.testing.assert_array_equal(got.numpy(), w)


def test_package_reexports():
    """``repro_torch.models`` re-exports the reference's entry points and
    submodules; ``repro_torch.core`` imports its submodules, as the
    reference's packages do."""
    for name in ("decode_step", "forward", "init_decode_state",
                 "init_params", "lm_loss", "param_specs", "prefill"):
        assert getattr(ref_models, name).__name__ == name
        assert getattr(models, name) is getattr(models.transformer, name)
    for name in ("layers", "pim", "ssm", "transformer"):
        assert getattr(models, name).__name__ == f"repro_torch.models.{name}"
    ref_subs = sorted(n for n in vars(ref_core)
                      if getattr(getattr(ref_core, n), "__name__", "")
                      == f"repro.core.{n}")
    assert ref_subs and all(
        getattr(core, n).__name__ == f"repro_torch.core.{n}"
        for n in ref_subs)


def test_jamba_config_name():
    assert configs.JAMBA_15_LARGE is configs.JAMBA15_LARGE
    assert dataclasses.asdict(configs.JAMBA_15_LARGE) == \
        dataclasses.asdict(ref_configs.JAMBA_15_LARGE)
