"""The port's post-processing against the JAX package's, on the CPU.

- `densecrf.mean_field_gaussian` on the same probabilities at several
  sizes and `sxy` (H and W at least the kernel's length, where JAX's
  ``jnp.convolve(mode="same")`` keeps the size): within 1e-5.
- `densecrf.refine_mask`: the native route (native/libdensecrf.so) equal
  to JAX's; with both loaders stubbed to find no library, the
  approximation route equal to JAX's.
- `nms.nms_numpy`, `nms_native` and `nms_torch` against JAX's
  `nms_numpy`, `nms_native` and `nms_jax` on seeded boxes with ties:
  the same keep sets (index lists in score order; masks).
- `evaluator.evaluate(use_crf=True)` (CMPC_model, TINY, five samples of
  native sizes, batches of 4) and `cli -m test -c` on fake npz batches:
  the no-CRF and the CRF results' IoUs within 1e-5 of JAX's, precisions
  equal.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmpc_refseg_torch import cli as tcli
from cmpc_refseg_torch.config import get_config as tget
from cmpc_refseg_torch.convert import params_from_jax
from cmpc_refseg_torch.data.image import IMAGE_MEAN_BGR, resize_and_pad
from cmpc_refseg_torch.ops import densecrf as tcrf
from cmpc_refseg_torch.ops import nms as tnms
from cmpc_refseg_torch.train import evaluator as tev
from cmpc_refseg_tpu import cli as jcli
from cmpc_refseg_tpu.config import get_config as jget
from cmpc_refseg_tpu.models.model import init_model as jinit
from cmpc_refseg_tpu.ops import densecrf as jcrf
from cmpc_refseg_tpu.ops import nms as jnms
from cmpc_refseg_tpu.train import evaluator as jev

torch.set_num_threads(2)

TINY = dict(H=32, W=32, num_steps=8, vocab_size=7, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, res4_blocks=2,
            batch_size=4)
TINY_ARGS = ["-H", "32", "-W", "32", "-T", "8", "-rnn_size", "16",
             "-v_emb_dim", "16", "-mlp_dim", "12", "-glove_dim", "8",
             "-res4_blocks", "2", "-vocab_size", "7"]


def _noisy_prob(rng, b, h, w):
    """A box of foreground probability 0.8 in 0.2, with noise."""
    p = np.full((b, h, w), 0.2, np.float32)
    p[:, h // 4:3 * h // 4, w // 3:5 * w // 6] = 0.8
    return np.clip(p + 0.3 * rng.standard_normal(p.shape), 0.01,
                   0.99).astype(np.float32)


@pytest.mark.parametrize("b, h, w, sxy, compat", [
    (2, 40, 33, 3.0, 3.0), (1, 64, 48, 1.5, 6.0), (3, 13, 20, 2.0, 3.0)])
def test_mean_field_gaussian_matches_jax(rng, b, h, w, sxy, compat):
    p = _noisy_prob(rng, b, h, w)
    want = np.asarray(jcrf.mean_field_gaussian(jnp.asarray(p), sxy=sxy,
                                               compat=compat))
    got = tcrf.mean_field_gaussian(torch.from_numpy(p), sxy=sxy,
                                   compat=compat)
    assert got.dtype == torch.float32 and got.shape == (b, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _crf_case(rng):
    rgb = np.zeros((36, 48, 3), np.uint8)
    rgb[9:27, 16:40] = (200, 60, 40)
    rgb = np.clip(rgb + rng.integers(0, 30, rgb.shape), 0, 255).astype(
        np.uint8)
    return rgb, _noisy_prob(rng, 1, 36, 48)[0]


def test_refine_mask_native_matches_jax(rng):
    assert tcrf.native_available() and jcrf.native_available()
    rgb, prob = _crf_case(rng)
    got = tcrf.refine_mask(rgb, prob)
    assert got.dtype == bool and got.shape == prob.shape
    np.testing.assert_array_equal(got, jcrf.refine_mask(rgb, prob))
    # the CRF changes the noisy mask
    assert (got != (prob > 0.5)).any()


def test_refine_mask_approximation_matches_jax(rng, monkeypatch):
    for mod in (tcrf, jcrf):
        monkeypatch.setattr(mod, "_NATIVE", None)
        monkeypatch.setattr(mod, "_NATIVE_TRIED", True)
    assert not tcrf.native_available()
    rgb, prob = _crf_case(rng)
    np.testing.assert_array_equal(tcrf.refine_mask(rgb, prob),
                                  jcrf.refine_mask(rgb, prob))


def _dets(rng, n=80):
    xy = rng.random((n, 2)) * 60
    wh = rng.random((n, 2)) * 30 + 2
    scores = np.round(rng.random((n, 1)), 1)       # ties in score
    return np.concatenate([xy, xy + wh, scores], 1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_keep_sets_match_jax(rng, thresh):
    dets = _dets(rng)
    want = jnms.nms_numpy(dets, thresh)
    assert tnms.nms_numpy(dets, thresh) == want
    assert tnms.nms_native(dets, thresh) == jnms.nms_native(dets, thresh)
    mask = tnms.nms_torch(torch.from_numpy(dets[:, :4]),
                          torch.from_numpy(dets[:, 4]), thresh)
    jmask = np.asarray(jnms.nms_jax(jnp.asarray(dets[:, :4]),
                                    jnp.asarray(dets[:, 4]), thresh))
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert 5 < mask.sum() < len(dets)


def _eval_samples(cfg, seed=3, n=5):
    """Samples of several native sizes with their native image (the CRF's
    pairwise image) and a blob mask."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        oh, ow = 40 + 4 * i, 36 + 5 * i
        native = rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:oh, :ow]
        mask = ((yy - oh / 2) ** 2 + (xx - ow / 3) ** 2) < (oh / 3) ** 2
        im = resize_and_pad(native.astype(np.float32), cfg.H, cfg.W)
        k = int(rng.integers(2, cfg.num_steps + 1))
        words = np.zeros((1, cfg.num_steps), np.int32)
        words[0, :k] = rng.integers(3, cfg.vocab_size, k)
        out.append({"im": (im[..., ::-1] - IMAGE_MEAN_BGR)[None].astype(
                        np.float32), "words": words,
                    "seq_len": np.asarray([k], np.int32),
                    "orig_size": (oh, ow), "target_native": mask,
                    "im_native": native})
    return out


def _check(got, want):
    assert got["n"] == want["n"]
    for k, v in want.items():
        if k.startswith("prec@"):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-5, k


def test_evaluate_with_crf_matches_jax():
    jcfg, tcfg = jget("CMPC_model", **TINY), tget("CMPC_model", **TINY)
    params, state = jax.tree.map(np.asarray,
                                 jinit(jax.random.PRNGKey(0), jcfg))
    samples = _eval_samples(tcfg)
    want = jev.evaluate(jcfg, params, state, iter(samples), use_crf=True,
                        batch_size=4)
    got = tev.evaluate(tcfg, params_from_jax(params, tcfg, device="cpu"), {},
                       iter(samples), use_crf=True, batch_size=4,
                       device="cpu")
    assert set(got) == set(want) == {"no_crf", "crf"}
    for k in want:
        _check(got[k], want[k])
    assert got["crf"]["n"] == 5


def _printed(text):
    """{section: {name: value}} of print_results' printout."""
    out, section = {}, None
    for line in text.splitlines():
        head = re.match(r"=== (\w+) ===", line)
        if head:
            section = out.setdefault(head.group(1), {})
            continue
        m = re.match(r"(overall IoU|mean IoU|precision@[\d.]+) = ([-\d.]+)",
                     line)
        if m:
            section[m.group(1)] = float(m.group(2))
    return out


def test_cli_crf_flag_matches_jax(tmp_path):
    """`-m test -c` from the seed-0 weights (no checkpoint) on three npz
    eval samples of native sizes: both sections of the printout within
    1e-5 of JAX's."""
    eval_dir = tmp_path / "unc" / "val_batch"
    os.makedirs(eval_dir)
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(40, 56), (30, 30), (50, 36)]):
        text = np.zeros((8,), np.int32)
        text[:2 + i % 2] = [3, 4, 5][:2 + i % 2]
        mask = np.zeros((h, w), bool)
        mask[h // 4:3 * h // 4, w // 5:3 * w // 5] = True
        np.savez(eval_dir / f"unc_val_{i}.npz", text_batch=text,
                 im_batch=rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                 mask_batch=mask)
    args = ["-m", "test", "-d", "unc", "-t", "val", "-n", "CMPC_model",
            "-f", str(tmp_path), "-ckpt_dir", str(tmp_path / "none"),
            "-emb_dir", str(tmp_path), "-c"] + TINY_ARGS
    printed = []
    for main, extra in ((jcli.main, []), (tcli.main, ["-device", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(args + extra)
        printed.append(_printed(out.getvalue()))
    got, want = printed
    assert set(got) == set(want) == {"no_crf", "crf"}
    for section, values in want.items():
        assert set(got[section]) == set(values) and len(values) == 7
        for k, v in values.items():
            assert abs(got[section][k] - v) <= 1e-5, (section, k)
