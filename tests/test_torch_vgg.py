"""The port's VGG16-FCN backbone against the JAX package's, in float32 on
the CPU: the parameters from one seed bit-equal (draw for draw the same
init), and every named activation of a 1x64x64 image within 1e-4 of its
largest entry (float32 convs summing in other orders; fc6 sums 25088
products)."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch.convert import vgg16_fcn_from_jax
from cmpc_refseg_torch.models import vgg16_fcn as tvgg
from cmpc_refseg_tpu.models import vgg16_fcn as jvgg

torch.set_num_threads(2)

NAMES = ("conv1_1", "conv1_2", "pool1", "conv2_1", "conv2_2", "pool2",
         "conv3_1", "conv3_2", "conv3_3", "pool3", "conv4_1", "conv4_2",
         "conv4_3", "conv5_1", "conv5_2", "conv5_3", "fc6", "fc7", "fc8")


def _jax_side(im):
    params = jvgg.init_vgg16_fcn(0)
    return params, {k: np.asarray(v) for k, v in
                    jvgg.apply_vgg16_fcn(params, jnp.asarray(im)).items()}


@pytest.fixture(scope="module")
def forwards():
    """Both packages' parameters and activations; JAX's in a thread beside
    the port's (numpy's draws and XLA's compiles run without the GIL)."""
    im = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(
        np.float32) * 50
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(_jax_side, im)
        got_p = tvgg.init_vgg16_fcn(0)
        want_p, want = jax_side.result()
    params = vgg16_fcn_from_jax(got_p, device="cpu")
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in
               tvgg.apply_vgg16_fcn(params, torch.from_numpy(im)).items()}
    return {"want_p": want_p, "got_p": got_p, "params": params,
            "want": want, "got": got}


def test_init_matches_jax_bit_for_bit(forwards):
    want, got = forwards["want_p"], forwards["got_p"]
    assert list(got) == list(want) and len(got) == 16
    for name in want:
        for k in ("DW", "biases"):
            w, g = np.asarray(want[name][k]), got[name][k]
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, k)
    assert got["fc6"]["DW"].shape == (7, 7, 512, 4096)
    assert got["fc8"]["DW"].shape == (1, 1, 4096, 1000)


@pytest.mark.parametrize("name", NAMES)
def test_activation_matches_jax(forwards, name):
    want, got = forwards["want"][name], forwards["got"][name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_shapes_and_compute_dtype(forwards):
    """Stride 8 after three pools; conv4, conv5 and the fc layers stay at
    pool3's resolution; a bf16 compute dtype runs the convs in bf16."""
    got = forwards["got"]
    assert got["pool3"].shape == (1, 8, 8, 256)
    assert got["conv5_3"].shape == (1, 8, 8, 512)
    assert got["fc8"].shape == (1, 8, 8, 1000)
    assert set(got) == set(NAMES)
    params = forwards["params"]
    im = torch.zeros((1, 16, 16, 3))
    with torch.inference_mode():
        out = tvgg.apply_vgg16_fcn(params, im, compute_dtype=torch.bfloat16)
    assert out["fc8"].dtype == torch.bfloat16
    assert out["fc8"].shape == (1, 2, 2, 1000)
