"""The port's int8 backbone serving path against the JAX package's, in
float32 on the CPU at the TINY geometry (res4_blocks=2, 32x32 images).

- `quantize_backbone`: every unit's `w_q` (int8, OIHW against JAX's HWIO)
  and `w_scale` bit-equal to JAX's (both divide in float32 and round half
  to even); the f32 kernel dropped.
- Per unit class (7x7/2 with K 147 -> 152, 1x1, 1x1/2, 3x3 at dilations 1,
  2 and 4), fed the same f32 input: the int8 codes and the int32
  accumulations equal to JAX's (`conv_general_dilated` of int8 with int32
  out), the unit's output (the BN epilogue) within 1 float32 ulp of its
  magnitude; the GEMM route the card takes (`int8_conv_gemm`: the im2col
  and `torch._int_mm`, here on the CPU) equal to the plain float64 conv.
- `apply_backbone` taps c2-c5, dynamic and calibrated scales, within
  1e-4 of each tap's largest entry (a code that a rounding tie flips is
  named by the unit that first differs).
- `calibrate_backbone`'s x_scale within 1e-6 relative.
- The flagship forward with `prepare_params(quantize_backbone=True)`:
  sigm within atol 1e-4, the whole forward's bound (JAX's backbone op by
  op, its head jitted on those taps).

JAX runs these op by op (`jax.disable_jit`), as the port computes.
Jitted, XLA fuses an epilogue's multiply and add (one rounding fewer):
a 1-ulp change of a unit's output can move a later unit's code by one
step, which moved a later abs-max by ~1e-3 (calibration images of another
seed) and the jitted forward's sigm by up to ~7e-4 from JAX's own op by
op forward, which the port matches.
- `PredictService(quantize=True)` without and with calibration images
  against JAX's: prob within atol 1e-4.

The JAX services are built in threads while the op-by-op references
run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import backbone_from_jax
from cmpc_refseg_torch.models import backbone as tbb
from cmpc_refseg_torch.models.model import apply_model as tapply
from cmpc_refseg_torch.models.model import init_model as tinit
from cmpc_refseg_torch.models.model import prepare_backbone, prepare_params
from cmpc_refseg_torch.serving import server as tserver
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models import backbone as jbb
from cmpc_refseg_tpu.models import model as jmodel
from cmpc_refseg_tpu.models.model import apply_model as japply
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.models.model import prepare_params as jprepare
from cmpc_refseg_tpu.ops.layers import DIMS
from cmpc_refseg_tpu.serving import server as jserver
from test_torch_serving import TINY, VOCAB

torch.set_num_threads(2)

RES4 = 2
# (unit, stride, dilation) of each shape class, as apply_backbone runs it
UNITS = {"conv1 7x7/2": (("conv1",), 2, 1),
         "1x1": (("res2a", "branch2a"), 1, 1),
         "1x1/2": (("res3a", "branch1"), 2, 1),
         "3x3": (("res2a", "branch2b"), 1, 1),
         "3x3 dilation 2": (("res4a", "branch2b"), 1, 2),
         "3x3 dilation 4": (("res5a", "branch2b"), 1, 4)}
F32 = tget("CMPC_model", **TINY)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unit(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _calibration_images():
    return [np.random.default_rng(i).standard_normal(
        (1, 32, 32, 3)).astype(np.float32) * 50 for i in range(2)]


def _request():
    return (np.random.default_rng(0).integers(0, 256, (40, 56, 3),
                                              dtype=np.uint8),
            "the red man on the left")


def _jax_service_prob(calibrated):
    """JAX's `PredictService(quantize=True)` answer to `_request`, without
    or with calibration images."""
    jcfg = jget("CMPC_model", **TINY)
    jp, js = jinit(0, jcfg)
    jsvc = jserver.PredictService(
        jcfg, jp, js, VOCAB, quantize=True,
        calibration_images=_calibration_images() if calibrated else None)
    return jsvc.predict(*_request())[0]


@pytest.fixture(scope="module")
def jax_services():
    """The JAX services' answers, computed in two threads while the
    op-by-op references below run (XLA compiles without the GIL, and
    `jax.disable_jit` holds in its own thread only)."""
    with ThreadPoolExecutor(2) as pool:
        yield {c: pool.submit(_jax_service_prob, c) for c in (False, True)}


@pytest.fixture(scope="module")
def backbones(jax_services):
    """JAX's f32 and quantized backbones from seed 0, the port's own
    quantization of the f32 one (prepared), and two calibration images."""
    p = jbb.init_backbone(0, RES4)
    pq = jbb.quantize_backbone(p)
    port_q = prepare_backbone(tbb.quantize_backbone(
        backbone_from_jax(p, device="cpu")), F32)
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32) * 50
              for _ in range(2)]
    with jax.disable_jit():
        jax_cal = jbb.calibrate_backbone(pq, images, res4_blocks=RES4)
    return {"jax": pq, "port": port_q, "images": images, "jax_cal": jax_cal,
            "port_cal": tbb.calibrate_backbone(port_q, images,
                                               res4_blocks=RES4)}


def test_quantize_matches_jax_bit_for_bit(backbones):
    want = dict(_leaves(backbone_from_jax(backbones["jax"], device="cpu")))
    got = {p: v for p, v in _leaves(backbones["port"]) if p[-1] != "w_gemm"}
    assert got.keys() == want.keys() and len(got) == 4 * 41
    assert not any(p[-1] == "w" for p in got)
    for p, w in want.items():
        assert got[p].dtype == w.dtype and torch.equal(got[p], w), p
    assert got[("conv1", "w_q")].dtype == torch.int8


def _jax_unit(unit, x, stride, dilation):
    """JAX's codes, int32 accumulations and unit output on NHWC `x`."""
    x = jnp.asarray(x)
    s_x = (jnp.max(jnp.abs(x)) + 1e-12) / 127.0
    xq = jnp.clip(jnp.round(x / s_x), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, unit["w_q"], window_strides=(stride, stride), padding="SAME",
        rhs_dilation=(dilation, dilation), dimension_numbers=DIMS,
        preferred_element_type=jnp.int32)
    out = jbb._conv_bn(unit, x, stride=stride, dilation=dilation)
    return [np.asarray(a) for a in (xq, acc, out)]


@pytest.mark.parametrize("name", list(UNITS))
def test_unit_codes_and_accumulations_match_jax(backbones, name):
    path, stride, dilation = UNITS[name]
    unit = _unit(backbones["port"], path)
    cin = unit["w_q"].shape[1]
    rng = np.random.default_rng(len(name))
    x = (rng.standard_normal((2, 17, 19, cin)) * 3).astype(np.float32)
    want_q, want_acc, want_out = _jax_unit(_unit(backbones["jax"], path), x,
                                           stride, dilation)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    s_x = (xt.abs().amax() + 1e-12) / 127
    xq = tbb.quantize_input(xt, s_x)
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), want_q)
    acc = tbb.int8_conv_plain(xq, unit["w_q"], stride=stride,
                              dilation=dilation)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    gemm = tbb.int8_conv_gemm(xq, unit["w_gemm"],
                              ksize=unit["w_q"].shape[2], stride=stride,
                              dilation=dilation)
    assert gemm.dtype == torch.int32 and torch.equal(gemm, acc)
    out = tbb._conv_bn(unit, xt, stride=stride, dilation=dilation)
    out = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, want_out, rtol=0,
                               atol=np.spacing(np.abs(want_out)).max())


@pytest.mark.parametrize("calibrated", [False, True])
def test_backbone_taps_match_jax(backbones, calibrated):
    jp = backbones["jax_cal" if calibrated else "jax"]
    tp = backbones["port_cal" if calibrated else "port"]
    x = np.random.default_rng(5).standard_normal((1, 32, 32, 3)).astype(
        np.float32) * 50
    with jax.disable_jit():
        want = jbb.apply_backbone(jp, jnp.asarray(x), res4_blocks=RES4)
    got = tbb.apply_backbone(tp, torch.from_numpy(x), res4_blocks=RES4)
    for tap in ("c2", "c3", "c4", "c5"):
        w = np.asarray(want[tap])
        err = np.abs(got[tap].numpy() - w).max() / np.abs(w).max()
        if err > 1e-4:
            pytest.fail(f"{tap}: {err:.3e} of the tap; first unit whose "
                        f"output differs: {_first_diverging_unit(jp, tp, x)}")


def _first_diverging_unit(jp, tp, x):
    """The first conv unit whose recorded input abs-max differs between
    the packages (a flipped code changes the next unit's input)."""
    want, got = {}, {}
    with jax.disable_jit():
        jbb.apply_backbone(jp, jnp.asarray(x), res4_blocks=RES4, record=want)
    tbb.apply_backbone(tp, torch.from_numpy(x), res4_blocks=RES4, record=got)
    for name in want:
        if float(want[name]) != float(got[name]):
            return name
    return None


def test_calibration_matches_jax(backbones):
    want = {p: float(v) for p, v in _leaves(backbone_from_jax(
        backbones["jax_cal"], device="cpu")) if p[-1] == "x_scale"}
    got = {p: float(v) for p, v in _leaves(backbones["port_cal"])
           if p[-1] == "x_scale"}
    assert got.keys() == want.keys() and len(want) == 41
    for p, w in want.items():
        assert abs(got[p] - w) <= 1e-6 * w, p


def test_quantized_flagship_forward_matches_jax(monkeypatch, jax_services):
    """JAX's int8 backbone runs op by op, as in the tests above; its head
    runs jitted on those taps (the head has no int8 codes to flip, and
    op by op it costs ~4x the time)."""
    # the services' threads call JAX's apply_backbone, patched below
    for future in jax_services.values():
        future.result()
    jcfg, tcfg = jget("CMPC_model", **TINY), tget("CMPC_model", **TINY)
    jp, js = jinit(0, jcfg)
    rng = np.random.default_rng(2)
    words = np.zeros((1, tcfg.num_steps), np.int32)
    words[0, :5] = [5, 6, 7, 8, 9]
    batch = {"im": rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
             * 50, "words": words, "seq_len": np.array([5], np.int32)}
    jpp = jprepare(jp, jcfg, quantize_backbone=True)
    with jax.disable_jit():
        taps = jbb.apply_backbone(jpp["backbone"], jnp.asarray(batch["im"]),
                                  taps=tuple(jcfg.levels),
                                  res4_blocks=jcfg.res4_blocks)
    assert set(taps) == set(jcfg.levels)

    def op_by_op_backbone(params, im, **kw):
        assert kw["compute_dtype"] is None
        assert kw["taps"] == tuple(jcfg.levels)
        return taps
    monkeypatch.setattr(jmodel, "apply_backbone", op_by_op_backbone)
    want, _ = jax.jit(lambda p, b: japply(p, js, jcfg, b))(
        jpp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = prepare_params(tinit(0, tcfg, device="cpu"), tcfg,
                            quantize_backbone=True)
    assert "w" not in params["backbone"]["conv1"]
    with torch.inference_mode():
        got = tapply(params, tcfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(got.sigm.numpy(), np.asarray(want.sigm),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantized_service_matches_jax(jax_services, calibrated):
    tcfg = tget("CMPC_model", **TINY)
    tsvc = tserver.PredictService(
        tcfg, tinit(0, tcfg, device="cpu"), VOCAB, device="cpu",
        quantize=True,
        calibration_images=_calibration_images() if calibrated else None)
    assert ("x_scale" in tsvc.params["backbone"]["res5c"]["branch2c"]) \
        == calibrated
    want = jax_services[calibrated].result()
    prob, mask = tsvc.predict(*_request())
    assert prob.shape == mask.shape == (40, 56)
    np.testing.assert_allclose(prob, want, rtol=0, atol=1e-4)
