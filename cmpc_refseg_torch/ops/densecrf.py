"""DenseCRF mean-field refinement, the port of the JAX package's
ops/densecrf.py.

The reference refines eval masks with pydensecrf's C++ DenseCRF2D
(trainval_model.py:246-259): 2 classes, unary = -log([1-p, p]),
PairwiseGaussian(sxy=3, compat=3) + PairwiseBilateral(sxy=20, srgb=3,
rgbim, compat=10), 5 mean-field iterations.

Two implementations:
1. `refine_mask`: the exact path through the repository's native C++
   permutohedral DenseCRF (native/densecrf.cpp, `native/libdensecrf.so`,
   called through ctypes, as the JAX package calls it), matching
   pydensecrf's semantics.
2. `mean_field_gaussian`: batched mean field with a separable Gaussian
   spatial pairwise term (no bilateral term) in torch, on the tensor's
   device: the approximation `refine_mask` falls back to where the
   library does not load or fails.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
import torch.nn.functional as F

_NATIVE = None
_NATIVE_TRIED = False

CRF_PARAMS = dict(sxy_gaussian=3.0, compat_gaussian=3.0,
                  sxy_bilateral=20.0, srgb_bilateral=3.0,
                  compat_bilateral=10.0, num_iters=5)


def native_library_path() -> str:
    """The repository's `native/libdensecrf.so` (`make -C native`)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "native", "libdensecrf.so")


def _load_native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    path = native_library_path()
    if os.path.isfile(path):
        lib = ctypes.CDLL(path)
        lib.densecrf2d_refine.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),   # rgb [H,W,3]
            ctypes.POINTER(ctypes.c_float),   # prob [H,W] fg probability
            ctypes.POINTER(ctypes.c_float),   # out  [H,W]
            ctypes.c_int, ctypes.c_int,       # H, W
            ctypes.c_float, ctypes.c_float,   # sxy_g, compat_g
            ctypes.c_float, ctypes.c_float,   # sxy_b, srgb
            ctypes.c_float,                   # compat_b
            ctypes.c_int,                     # iters
        ]
        lib.densecrf2d_refine.restype = ctypes.c_int
        _NATIVE = lib
    return _NATIVE


def native_available() -> bool:
    return _load_native() is not None


def refine_mask(rgb_image: np.ndarray, fg_prob: np.ndarray,
                threshold: float = 0.5, **overrides) -> np.ndarray:
    """Binary refined mask [H, W] of one image: rgb_image uint8 [H, W, 3],
    fg_prob float [H, W] in (0, 1).  The native exact DenseCRF where it
    loads and succeeds; otherwise `mean_field_gaussian` on the CPU, with
    the bilateral compatibility folded into the Gaussian's (x 0.3), as the
    JAX package does."""
    p = {**CRF_PARAMS, **overrides}
    h, w = fg_prob.shape
    rgb = np.ascontiguousarray(rgb_image[:, :, :3], dtype=np.uint8)
    prob = np.ascontiguousarray(fg_prob, dtype=np.float32)
    lib = _load_native()
    if lib is not None:
        out = np.empty((h, w), dtype=np.float32)
        rc = lib.densecrf2d_refine(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w,
            p["sxy_gaussian"], p["compat_gaussian"],
            p["sxy_bilateral"], p["srgb_bilateral"], p["compat_bilateral"],
            p["num_iters"])
        if rc == 0:
            return out > threshold
    q = mean_field_gaussian(torch.from_numpy(prob)[None],
                            num_iters=p["num_iters"], sxy=p["sxy_gaussian"],
                            compat=p["compat_gaussian"]
                            + p["compat_bilateral"] * 0.3)
    return q[0].numpy() > threshold


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k[radius] = 0.0   # DenseCRF excludes self-connection
    return k.astype(np.float32)


def _blur(q, kern):
    """Separable filtering of q [B, H, W] by the odd-length 1-D `kern`
    along H, then along W, with zero padding to the same size (the JAX
    package's ``jnp.convolve(mode="same")`` per column and row, for H and
    W at least the kernel's length; the kernel is symmetric, so the
    correlation is the convolution)."""
    b, h, w = q.shape
    r = (kern.numel() - 1) // 2
    k = kern.view(1, 1, -1)
    cols = q.transpose(1, 2).reshape(b * w, 1, h)
    q = F.conv1d(cols, k, padding=r).reshape(b, w, h).transpose(1, 2)
    return F.conv1d(q.reshape(b * h, 1, w), k, padding=r).reshape(b, h, w)


def mean_field_gaussian(fg_prob, *, num_iters: int = 5, sxy: float = 3.0,
                        compat: float = 3.0):
    """Batched binary mean-field CRF with a separable Gaussian spatial
    kernel (no color term): fg_prob [B, H, W] float32 -> the refined
    foreground probability [B, H, W], on fg_prob's device.  Two separable
    1-D convolutions per message."""
    radius = max(1, int(2 * sxy))
    # the blur kernel INCLUDING self for the normalizer (the lattice's
    # semantics); the message excludes self by subtraction below
    k = _gaussian_kernel1d(sxy, radius)
    k[radius] = 1.0
    k_full = torch.as_tensor(k, device=fg_prob.device)
    fg_prob = fg_prob.float()
    unary_fg = -torch.log(torch.clamp(fg_prob, 1e-8, 1.0))
    unary_bg = -torch.log(torch.clamp(1.0 - fg_prob, 1e-8, 1.0))
    # symmetric kernel normalization (densecrf v2: norm = 1/sqrt(K 1),
    # message = norm * K(norm * Q)): without it messages scale with the
    # kernel mass (~(2 sum k)^2) and crush the unaries
    norm = torch.reciprocal(torch.sqrt(_blur(torch.ones_like(fg_prob),
                                             k_full) + 1e-20))

    def message(q):
        return norm * _blur(norm * q, k_full) - (norm ** 2) * q

    q_fg = fg_prob
    for _ in range(num_iters):
        q_bg = 1.0 - q_fg
        msg_fg = message(q_fg)
        msg_bg = message(q_bg)
        # Potts: label l is penalized by the mass of the OTHER label
        logit_fg = -unary_fg - compat * msg_bg
        logit_bg = -unary_bg - compat * msg_fg
        m = torch.maximum(logit_fg, logit_bg)
        e_fg = torch.exp(logit_fg - m)
        e_bg = torch.exp(logit_bg - m)
        q_fg = e_fg / (e_fg + e_bg)
    return q_fg
