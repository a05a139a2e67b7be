"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so these tests need a CUDA device and skip
without one.  The file imports no JAX, so it runs on a GPU machine without
it (tests/conftest.py imports JAX; skip it there):

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Shapes are small and ragged on purpose: row counts, K and column widths
that are not multiples of the kernels' tiles exercise the masked edges.
chip_smoke.py does the same checks at the flagship shapes.  Tolerance: the
largest error within 1e-2 of the reference's largest entry.  The kernel
and its plain version round to bf16 at the same places but sum in other
orders, so a rounding may land one bf16 ulp apart, which is at most 2^-7
of the entry.  The layer-norm statistics, given as (sum, sum of squares)
partials, are held per sample as a mean and a variance, each within
STATS_TOL of its own scale: the same f32 sums in other orders move them far
less, while a wrong or missing column moves them by its whole size."""

import re

import numpy as np
import pytest
import torch

from cmpc_refseg_torch.ops import build, kernels

TOL = 1e-2
STATS_TOL = 1e-3


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; CUDA kernels have no CPU mode")
    # the plain versions' float32 products and convs in full float32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def _moments(stats, count):
    """Per-sample (mean, variance) from (sum, sum of squares) partials."""
    s = stats.double().sum(1)
    mean = s[:, 0] / count
    return mean, s[:, 1] / count - mean * mean


# which outputs of each wrapper are statistics partials [B, P, (Q,) 2]
STATS_OUTPUTS = {"graph_msg": 1, "graph_update": 1, "graph_update_grouped": 1,
                 "convlstm_gates": 1, "convlstm_raw": 2}


def _close_stats(got, want, count):
    """The two columns held apart, each at its own scale: the mean's error
    over the std and the variance's relative error, within STATS_TOL per
    sample, for each statistic Q of [B, P, Q, 2] partials."""
    if got.dim() == 3:
        got, want = got[:, :, None], want[:, :, None]
    for q in range(got.shape[2]):
        (gm, gv), (wm, wv) = (_moments(got[:, :, q], count),
                              _moments(want[:, :, q], count))
        assert ((gm - wm).abs() <= STATS_TOL * wv.sqrt()).all()
        assert ((gv - wv).abs() <= STATS_TOL * wv).all()


def _close(name, got, want, count):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (a, w) in enumerate(zip(got, want)):
        if STATS_OUTPUTS.get(name) == i:
            _close_stats(a, w, count)
            continue
        err = (a.float() - w.float()).abs().max().item()
        assert err <= TOL * w.float().abs().max().item()


def _inputs(g, name, l2n=False, masked=True):
    """(args, kwargs, count of entries per sample behind its statistics)."""
    b, n, c, t = 2, 100, 72, 6
    f32 = torch.float32
    mutan = ((_rnd(g, b * n, 80), _rnd(g, 80, 5 * c, scale=0.1),
              _rnd(g, 5 * c, dtype=f32), torch.tanh(_rnd(g, b, 5 * c,
                                                       dtype=f32))),
             {"heads": 5, "rows_per_sample": n})
    if name in ("mutan_fused", "mutan_fwd_residual"):
        return (*mutan, None)
    if name in ("mutan_bwd_dz", "mutan_dw"):
        # 100 rows per sample: the dz pass takes blocks of 25 rows; 200
        # rows, K = 80 and 5C = 360 leave ragged dW tiles
        _, v = kernels.mutan_fwd_residual_plain(*mutan[0], **mutan[1])
        dz_args = (v, mutan[0][3], _rnd(g, b * n, c, scale=0.1))
        if name == "mutan_bwd_dz":
            return (dz_args, mutan[1], None)
        dz, _, _ = kernels.mutan_bwd_dz_plain(*dz_args, **mutan[1])
        return (mutan[0][0], dz), {}, None
    if name in ("spa_affinity", "spa_affinity_grouped"):
        grouped = name.endswith("grouped")
        b = 3 if grouped else b           # 3 groups of 1 sample: batch 1
        lead = (b,) if grouped else ()
        mask = torch.ones(b, 1, t, device="cuda")
        mask[:, :, 4:] = 0
        return ((_rnd(g, b, n, c), _rnd(g, *lead, c, 40, scale=0.2),
                 _rnd(g, *lead, 40), _rnd(g, b, t, 40),
                 torch.rand(b, 1, t, generator=g, device="cuda"), mask),
                {"scale": 8.0, "l2n": l2n, "masked": masked}, None)
    if name == "graph_msg":
        return (_rnd(g, b, n, t), _rnd(g, b, t, c)), {}, n * c
    if name in ("graph_update", "graph_update_grouped"):
        grouped = name.endswith("grouped")
        b = 3 if grouped else b
        lead = (b,) if grouped else ()
        msg, st = kernels.graph_msg_plain(_rnd(g, b, n, t), _rnd(g, b, t, c))
        return ((_rnd(g, b, n, c), msg, st, _rnd(g, *lead, c, c, scale=0.1),
                 _rnd(g, *lead, c), 1 + _rnd(g, *lead, c, dtype=f32,
                                             scale=0.1),
                 _rnd(g, *lead, c, dtype=f32)), {}, n * c)
    # SE sum and ConvLSTM: C a multiple of 4 but not of 8 (8-byte rows)
    c = 36
    if name == "se_sum":
        return ((_rnd(g, b, n, c), [_rnd(g, b, n, c) for _ in range(2)],
                 [torch.sigmoid(_rnd(g, b, c)) for _ in range(2)],
                 [_rnd(g, c, c, scale=0.2) for _ in range(2)],
                 [_rnd(g, c, scale=0.1) for _ in range(2)]), {}, None)
    x, h, cell = (_rnd(g, b, n, c) for _ in range(3))
    w = _rnd(g, 2 * c, 4 * c, scale=0.2)
    ci, cf, co = (_rnd(g, n, c, scale=0.2) for _ in range(3))
    if name == "convlstm_gates":
        return (x, h, cell, w, ci, cf), {}, n * c
    gates, st = kernels.convlstm_gates_plain(x, h, cell, w, ci, cf)
    return ((gates, cell, co, st, 1 + _rnd(g, 5, c, dtype=f32, scale=0.1),
             _rnd(g, 5, c, dtype=f32, scale=0.1)), {}, n * c)


@pytest.mark.gpu
@pytest.mark.parametrize("name,l2n,masked", [
    ("mutan_fused", False, True), ("mutan_fwd_residual", False, True),
    ("mutan_bwd_dz", False, True), ("mutan_dw", False, True),
    ("spa_affinity", False, True), ("spa_affinity", False, False),
    ("spa_affinity", True, False), ("spa_affinity", True, True),
    ("graph_msg", False, True), ("graph_update", False, True),
    ("spa_affinity_grouped", False, True),
    ("spa_affinity_grouped", True, False),
    ("graph_update_grouped", False, True), ("se_sum", False, True),
    ("convlstm_gates", False, True), ("convlstm_raw", False, True)])
def test_kernel_matches_plain_version(cuda, name, l2n, masked):
    args, kw, count = _inputs(cuda, name, l2n, masked)
    wrapper = getattr(kernels, name)
    before = wrapper.launches
    got = wrapper(*args, **kw)
    want = kernels.PLAIN[wrapper](*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(name, got, want, count)


def _mutan_args(g, c, k, n=100, samples=3, heads=5):
    """Mutan inputs: samples * n rows (n = 100: a 64- or 128-row tile
    straddles two samples), K = k, heads * c columns of W."""
    return ((_rnd(g, samples * n, k), _rnd(g, k, heads * c, scale=0.1),
             _rnd(g, heads * c, dtype=torch.float32, scale=0.1),
             torch.tanh(_rnd(g, samples, heads * c, dtype=torch.float32))),
            {"heads": heads, "rows_per_sample": n})


@pytest.mark.gpu
@pytest.mark.parametrize("c,k,samples", [(72, 200, 3), (1000, 136, 3),
                                         (1000, 1008, 16)])
@pytest.mark.parametrize("residual", [False, True])
def test_mutan_tma_kernel_matches_plain_version(cuda, c, k, samples,
                                                residual):
    """Both forms of the TMA + wgmma mutan kernel: K = 200 or 136 is ragged
    against the 64-deep stages, 300 rows against the 128-row tiles (the
    grid is padded to whole 2 x 2 clusters), and C = 1000 against the
    128-column tiles, where the 3D tensor map of W must read zeros past
    each head's last column; then 1600 rows and K = 1008, the flagship's
    bs=1 widths."""
    args, kw = _mutan_args(cuda, c, k, samples=samples)
    got = kernels._mutan_launch(*args, kw["heads"], kw["rows_per_sample"],
                                residual)
    plain = kernels.mutan_fwd_residual_plain(*args, **kw)
    torch.cuda.synchronize()
    _close("mutan_fwd_residual", got[0], plain[0], None)
    if residual:
        _close("mutan_fwd_residual", got[1], plain[1], None)
    else:
        assert got[1] is None


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,w", [(64, 80, 360), (200, 80, 360),
                                   (1000, 136, 5 * 40), (1600, 1008, 5000)])
def test_mutan_dw_matches_torch_mm(cuda, m, k, w):
    """dW = x^T dz against torch.mm with an f32 result, within 1e-3 of the
    largest entry: the products of bf16 values are exact in f32, so only
    the order of the f32 sums differs.  Ragged M, K and W, and the
    flagship's K and W at bs=1; M = 64 is one tile of M, so the reduction
    runs unsplit, the others in two partials added in a fixed order.  A
    second launch gives the same bits."""
    x, dz = _rnd(cuda, m, k), _rnd(cuda, m, w, scale=0.1)
    got = kernels.mutan_dw(x, dz)
    want = torch.mm(x.t(), dz, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, kernels.mutan_dw(x, dz))


def _dz_args(g, b, n, c, zero_sample=False):
    """dz-pass inputs: v = tanh of a normal [b n, 5c] as the forward's
    residual, lang = tanh of a normal, g at the scale of a loss's
    cotangent; with `zero_sample` the v rows of sample 1 are zero, so their
    sq = 0 <= 1e-12 (the l2norm vjp's g * r branch)."""
    v = torch.tanh(_rnd(g, b * n, 5 * c, dtype=torch.float32))
    if zero_sample:
        v[n:2 * n] = 0
    return ((v.to(torch.bfloat16),
             torch.tanh(_rnd(g, b, 5 * c, dtype=torch.float32)),
             _rnd(g, b * n, c, scale=0.1)),
            {"heads": 5, "rows_per_sample": n})


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,zero_sample", [
    (8, 1600, 1000, False), (3, 25, 72, False), (2, 1681, 72, False),
    (1, 41, 12, False), (3, 25, 72, True), (1, 41, 2000, False),
    (2, 25, 4000, False)])
def test_mutan_bwd_dz_matches_plain_version(cuda, b, n, c, zero_sample):
    """The bulk-copy dz kernel (dz, dlang, db) against its plain version:
    the flagship's bs=8 train shapes; 25- and 41-row samples, where a
    block's rows cross samples; N = 1681, which no row count up to 32
    divides; C = 12, 72 and 1000 (4-byte vectors), 2000 (8-byte) and 4000
    (16-byte), each ring stage's byte range rounded out to 16-byte bounds;
    a sample whose v rows are zero."""
    args, kw = _dz_args(cuda, b, n, c, zero_sample)
    got = kernels.mutan_bwd_dz(*args, **kw)
    want = kernels.mutan_bwd_dz_plain(*args, **kw)
    torch.cuda.synchronize()
    _close("mutan_bwd_dz", got, want, None)


@pytest.mark.gpu
def test_mutan_bwd_dz_scratch_does_not_grow_with_rows_per_block(cuda):
    """The dz kernel's scratch is bounded by its grid: at bs=8 and N = 1681
    (prime factors 41 x 41, so 32-row blocks do not divide it) it is no
    larger than at N = 1600, and a launch at N = 1681 allocates no more."""
    at = {n: kernels.mutan_bwd_dz_scratch(8 * n, n, 1000, 5)
          for n in (1600, 1681)}
    assert at[1681][0] * at[1681][1] <= at[1600][0] * at[1600][1]
    args, kw = _dz_args(cuda, 8, 1681, 1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dz, dlang, db = kernels.mutan_bwd_dz(*args, **kw)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (dz, dlang, db))
    scratch = torch.cuda.max_memory_allocated() - before - outputs
    # the caching allocator rounds each of the four blocks up to 512 bytes
    assert scratch <= at[1600][0] * at[1600][1] * 4 + 4 * 512


def _raw_args(g, b, n, c):
    """convlstm_raw inputs: the gates and their statistics from the plain
    gates step, c, W_co and the layer norms' affine at the model's scales."""
    x, h, cell, w, ci, cf = _gates_args(g, b, n, c)
    gates, stats = kernels.convlstm_gates_plain(x, h, cell, w, ci, cf)
    return (gates, cell, _uniform(g, n, c, limit=0.1), stats,
            1 + _rnd(g, 5, c, dtype=torch.float32, scale=0.1),
            _rnd(g, 5, c, dtype=torch.float32, scale=0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c", [(1, 1600, 500), (3, 25, 12),
                                   (64, 100, 500)])
def test_convlstm_raw_matches_plain_version(cuda, b, n, c):
    """The streaming raw kernel against its plain version: the flagship's
    bs=1 shapes (16-byte vectors, the grid filling the card with one
    sample), 25-row samples at C = 12 (N * C = 300: 8-byte vectors, odd
    samples starting 8 bytes past a 16-byte bound) and 64 samples of 100
    rows (one block per sample or a few)."""
    args = _raw_args(cuda, b, n, c)
    got = kernels.convlstm_raw(*args)
    want = kernels.convlstm_raw_plain(*args)
    torch.cuda.synchronize()
    _close("convlstm_raw", got, want, n * c)


def _uniform(g, *shape, limit):
    u = torch.rand(*shape, generator=g, device="cuda") * 2 - 1
    return (u * limit).to(torch.bfloat16)


def _se_args(g, b, n, c, k):
    """SE-sum inputs at the model's scales: k others, b samples of n rows."""
    return (_rnd(g, b, n, c), [_rnd(g, b, n, c) for _ in range(k)],
            [torch.sigmoid(_rnd(g, b, c, dtype=torch.float32)).to(
                torch.bfloat16) for _ in range(k)],
            [_uniform(g, c, c, limit=(3 / c) ** 0.5) for _ in range(k)],
            [_rnd(g, c, scale=0.1) for _ in range(k)])


def _gates_args(g, b, n, c):
    """ConvLSTM gates inputs at the model's scales."""
    return (*(_rnd(g, b, n, c) for _ in range(3)),
            _uniform(g, 2 * c, 4 * c, limit=(1 / c) ** 0.5),
            _uniform(g, n, c, limit=0.1), _uniform(g, n, c, limit=0.1))


# (B, N, others): B*N = 75 is odd and 25- and 100-row samples straddle the
# 64- and 128-row tiles; 1600 rows per sample is the flagship's, and 8
# samples with one other level the two-level configs' bs=8 forward
SHAPES = [(1, 25, 1), (3, 25, 4), (3, 100, 2), (1, 1600, 3), (3, 1600, 2),
          (8, 1600, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("c", [12, 72, 500, 512])
@pytest.mark.parametrize("b,n,k", SHAPES)
def test_se_sum_wgmma_kernel_matches_plain_version(cuda, b, n, k, c):
    """The wgmma SE-sum kernel against its plain version: C = 12 and 72
    leave most of one 128-column slice empty, C = 500 ends inside the
    fourth slice and its 1000-byte rows are loaded by cp.async, C = 512
    fills four; 1-4 others; 64-row tiles (fewer blocks than SMs) and
    128-row tiles (3 samples of 1600 rows at C >= 500)."""
    args = _se_args(cuda, b, n, c, k)
    got = kernels.se_sum(*args)
    want = kernels.se_sum_plain(*args)
    torch.cuda.synchronize()
    _close("se_sum", got, want, None)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [12, 72, 500, 512])
@pytest.mark.parametrize("b,n", sorted({(b, n) for b, n, _ in SHAPES}))
def test_convlstm_gates_wgmma_kernel_matches_plain_version(cuda, b, n, c):
    """The wgmma gates kernel against its plain version (the gates and the
    layer-norm statistics per sample), then the raw kernel fed the gates
    kernel's statistics slots against the plain step fed the plain
    statistics.  C = 12 and 72 leave most of a 64-column chunk past C (the
    weight boxes read the next gate's columns there), C = 500 ends inside
    the eighth chunk and C = 512 fills it; padded row tiles of 25 and 100
    rows, odd B*N = 75."""
    args = _gates_args(cuda, b, n, c)
    gates, stats = kernels.convlstm_gates(*args)
    want = kernels.convlstm_gates_plain(*args)
    torch.cuda.synchronize()
    _close("convlstm_gates", (gates, stats), want, n * c)
    cell = args[2]
    rest = (_uniform(cuda, n, c, limit=0.1),
            1 + _rnd(cuda, 5, c, dtype=torch.float32, scale=0.1),
            _rnd(cuda, 5, c, dtype=torch.float32, scale=0.1))
    got = kernels.convlstm_raw(gates, cell, rest[0], stats, *rest[1:])
    ref = kernels.convlstm_raw_plain(want[0], cell, rest[0], want[1],
                                     *rest[1:])
    torch.cuda.synchronize()
    _close("convlstm_raw", got, ref, n * c)


def _word_mask(b, t):
    """[b, 1, t] f32: the first max(1, 2t/3) words of each sample on."""
    mask = torch.zeros(b, 1, t, device="cuda")
    mask[:, :, :max(1, 2 * t // 3)] = 1
    return mask


def _affinity_args(g, b, n, c, a, t, groups):
    """Affinity inputs at the model's scales: b samples of n rows, G =
    `groups` weight groups (0: the ungrouped form's [C, A] weights)."""
    lead = (groups,) if groups else ()
    return (_rnd(g, b, n, c), _uniform(g, *lead, c, a, limit=(3 / c) ** 0.5),
            _rnd(g, *lead, a, scale=0.1), _rnd(g, b, t, a),
            torch.rand(b, 1, t, generator=g, device="cuda"), _word_mask(b, t))


def _update_args(g, b, n, c, groups, t=20):
    """graph_update inputs at the model's scales, msg and its statistics
    from graph_msg's plain version (G = `groups`; 0: ungrouped)."""
    lead = (groups,) if groups else ()
    msg, st = kernels.graph_msg_plain(
        torch.softmax(_rnd(g, b, n, t, dtype=torch.float32), -1).to(
            torch.bfloat16), _rnd(g, b, t, c))
    return (_rnd(g, b, n, c), msg, st,
            _uniform(g, *lead, c, c, limit=(3 / c) ** 0.5),
            _rnd(g, *lead, c, scale=0.1),
            1 + _rnd(g, *lead, c, dtype=torch.float32, scale=0.1),
            _rnd(g, *lead, c, dtype=torch.float32, scale=0.1))


WORDS = [1, 33, 40, 64, 300]


@pytest.mark.gpu
@pytest.mark.parametrize("t", WORDS)
@pytest.mark.parametrize("l2n,masked", [(False, True), (False, False),
                                        (True, False), (True, True)])
@pytest.mark.parametrize("groups", [0, 2, 3])
def test_affinity_takes_any_word_count(cuda, groups, l2n, masked, t):
    """The wgmma affinity kernel in both forms (G = 2: the two-level
    configs' packed graph) and all four (l2n, masked) forms at T = 1 and
    past one 32-word chunk (33, 40, 64, 300): 6 samples of 100 rows (a
    128-row tile past each sample), C = 72, A = 40."""
    args = _affinity_args(cuda, 6, 100, 72, 40, t, groups)
    name = "spa_affinity_grouped" if groups else "spa_affinity"
    kw = {"scale": 72 ** 0.5, "l2n": l2n, "masked": masked}
    wrapper = getattr(kernels, name)
    got = wrapper(*args, **kw)
    want = kernels.PLAIN[wrapper](*args, **kw)
    torch.cuda.synchronize()
    _close(name, got, want, None)


@pytest.mark.gpu
@pytest.mark.parametrize("t", WORDS)
def test_graph_msg_takes_any_word_count(cuda, t):
    """The message kernel takes the words in pooled boxes of up to 64 (T =
    1, 33 and 40: one box of 16, 48, 48; 64: one; 300: five K chunks):
    msg and its statistics against the plain version."""
    w_aff = torch.softmax(_rnd(cuda, 2, 100, t, dtype=torch.float32),
                          -1).to(torch.bfloat16)
    args = (w_aff, _rnd(cuda, 2, t, 72))
    got = kernels.graph_msg(*args)
    want = kernels.graph_msg_plain(*args)
    torch.cuda.synchronize()
    _close("graph_msg", got, want, 100 * 72)


def _msg_args(g, b, n, t, c):
    """graph_msg inputs at the model's scales: w_aff a softmax over the
    words, pooled [b, t, c] standard normal."""
    return (torch.softmax(_rnd(g, b, n, t, dtype=torch.float32), -1).to(
        torch.bfloat16), _rnd(g, b, t, c))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("c", [8, 72, 1000, 1024])
@pytest.mark.parametrize("n", [75, 1600, 1681])
@pytest.mark.parametrize("t", [1, 16, 17, 20, 33, 300])
def test_graph_msg_tensor_core_kernel_matches_plain_version(cuda, t, n, c, b):
    """The mma + bulk-store message kernel: T = 16 is one k16 step, odd T
    leaves w_aff rows 2-byte aligned, 33 and 300 take 48- and 64-word
    pooled boxes (300 and C >= 1000: five K chunks streamed through a ring
    instead of resident); N = 75 and 1681 end in a ragged 16-row tile and
    32-row statistics group; C = 8, 72 and 1000 end in a partial
    64-column chunk, and C = 1000 rows are not 32-byte multiples."""
    args = _msg_args(cuda, b, n, t, c)
    got = kernels.graph_msg(*args)
    want = kernels.graph_msg_plain(*args)
    torch.cuda.synchronize()
    _close("graph_msg", got, want, n * c)


@pytest.mark.gpu
@pytest.mark.parametrize("c,t", [(2048, 20), (4096, 20), (2048, 300)])
def test_graph_msg_takes_wide_rows(cuda, c, t):
    """Rows too wide for two [32 x C] staging buffers: 16-row tiles, pooled
    streamed through per-warp rings instead of resident, and at C = 4096
    one staging buffer; N = 75 ends in a ragged tile."""
    args = _msg_args(cuda, 2, 75, t, c)
    got = kernels.graph_msg(*args)
    want = kernels.graph_msg_plain(*args)
    torch.cuda.synchronize()
    _close("graph_msg", got, want, 75 * c)


def _wide_call(name, args, kw=None):
    """One wrapper call that must go to the wrapper's wide form: its
    launches and wide launches each up by one; (kernel, plain) outputs."""
    kw = kw or {}
    wrapper = getattr(kernels, name)
    before = (wrapper.launches, wrapper.wide_launches)
    got = wrapper(*args, **kw)
    want = kernels.PLAIN[wrapper](*args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.wide_launches) == (before[0] + 1,
                                                         before[1] + 1)
    return got, want


# the message's wide form: C = 4096 with T = 300 (C * T past the plan),
# C past 4096; (6, 1600, 4104, 20) is phase 17's shape
WIDE_MSG = [(1, 16, 4096, 300), (2, 75, 4104, 20), (3, 100, 4104, 17),
            (6, 1600, 4104, 20), (2, 1681, 4104, 300), (2, 75, 4160, 17),
            (2, 75, 4352, 17), (1, 16, 8200, 1), (64, 100, 4104, 20),
            (1, 40, 4104, 600), (1, 40, 4104, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,t", WIDE_MSG)
def test_graph_msg_wide_form_where_the_plan_does_not_fit(cuda, b, n, c, t):
    """C = 4096 with T = 300 (or C past 4096) does not fit the message
    kernel's shared memory: the wrapper launches the wide form (the main
    pipeline over column slices), which agrees with the plain version (msg
    and its statistics, one slot per 32-row group and slice).  T = 17
    leaves w_aff rows 2-byte aligned; T = 300 takes five K chunks of
    pooled in 192-column slices, and N = 1681 ends in a 17-row group; at
    T = 17 and 20, C = 4104 ends 776 columns into an 832-column slice,
    C = 4160 fills its last one, C = 4352 ends 768 columns into a
    896-column slice, and C = 8200 (T = 1) 520 into a 960-column slice.
    64 samples of 100 rows put several 4-group slices in each block's
    range, whose boxes are reloaded.  At T = 600 not even a
    64-column slice keeps its boxes resident: they stream through the
    per-warp rings, in 16-row tiles; at T = 1500 the tiles also read
    w_aff's rows from device memory (no stage fits)."""
    lib = build.library("graph_conv")
    assert lib.cmpc_graph_msg_smem(1000, 20) > 0
    assert lib.cmpc_graph_msg_smem(4096, 300) == 0
    assert lib.cmpc_graph_msg_smem(4104, 1) == 0
    got, want = _wide_call("graph_msg", _msg_args(cuda, b, n, t, c))
    slots = lib.cmpc_graph_msg_wide_parts(n, c, t)
    assert slots % lib.cmpc_graph_msg_parts(n) == 0
    assert got[1].shape == (b, slots, 2)
    _close("graph_msg", got, want, n * c)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,t", [(6, 1600, 4104, 20), (2, 1681, 4104, 300),
                                     (64, 100, 4104, 20)])
def test_graph_msg_wide_form_repeats_bit_identically(cuda, b, n, c, t):
    """Two launches of the wide form give the same msg and statistics bits:
    each (group, slice) slot is summed in a fixed order, no atomics."""
    args = _msg_args(cuda, b, n, t, c)
    first, _ = _wide_call("graph_msg", args)
    again, _ = _wide_call("graph_msg", args)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,a,t", [(75, 72, 2056, 40), (75, 72, 4104, 40),
                                     (100, 72, 4104, 20),
                                     (1600, 4104, 4104, 20)])
@pytest.mark.parametrize("l2n,masked", [(False, True), (False, False),
                                        (True, False), (True, True)])
@pytest.mark.parametrize("groups", [0, 2, 3])
def test_affinity_wide_form_matches_plain_version(cuda, groups, l2n, masked,
                                                  n, c, a, t):
    """A past the 2048 columns one cluster of 8 x 256 covers: the wide
    form (the TMA + wgmma projection with per-block row-norm partials, then
    the word product and both softmaxes), G = 1 (the ungrouped form), 2
    and 3, on 6 samples: N = 75 and 100 leave a 64-row words tile and a
    128-row projection tile past each sample's end, 1600 is phase 17's
    (12.5 projection tiles, C = A = 4104); A = 2056 and 4104 end in an
    8-column box past the last 64 and 256; T = 40 takes two 32-word
    chunks."""
    args = _affinity_args(cuda, 6, n, c, a, t, groups)
    name = "spa_affinity_grouped" if groups else "spa_affinity"
    got, want = _wide_call(name, args, {"scale": c ** 0.5, "l2n": l2n,
                                        "masked": masked})
    _close(name, got, want, None)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1028, 1032, 2052, 4104])
@pytest.mark.parametrize("b,n,k", [(1, 25, 1), (3, 100, 2), (2, 75, 4),
                                   (2, 1600, 2)])
def test_se_sum_wide_form_matches_plain_version(cuda, b, n, k, c):
    """C past the 1024 columns one cluster of 8 x 128 covers: the wide
    form (the main pipeline without a cluster, row partials per 128-column
    slice, a norm pass), with 1, 2 and 4 others; row tiles straddle
    samples at N = 25, 100 and 75; (2, 1600, 2) at C = 1032 is phase 17's
    shape.  C = 1028 has 8-byte rows (8-byte norm accesses, a 4-column
    last slice), 1032, 2052 (17 slices) and 4104 16-byte rows."""
    got, want = _wide_call("se_sum", _se_args(cuda, b, n, c, k))
    _close("se_sum", got, want, None)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [0, 2, 3])
@pytest.mark.parametrize("n,slots", [(75, None), (100, None), (1600, None),
                                     (1600, 1625)])
def test_graph_update_wide_form_matches_plain_version(cuda, n, slots, groups):
    """C = 4104, past the 4096 columns of LN1's affine that the update
    kernel stages: the wide form (the update's pipeline with LN1's affine
    carried in the ring), G = 1 (the ungrouped form), 2 and 3, 6 samples
    of n rows (75 and 100 end in a part-filled 128-row tile, 1600 is
    phase 17's), an 8-column last K step and W box; its statistics in the
    main kernel's layout, one slot per 128 x 256 block.  msg's statistics
    come in as many slots as the message's wide form writes (one per
    32-row group and column slice, 250 a sample at N = 1600) or, to hold
    the block's strided sum of many slots, 1625."""
    lib = build.library("graph_conv")
    args = _update_args(cuda, 6, n, 4104, groups)
    slots = slots or lib.cmpc_graph_msg_wide_parts(n, 4104, 20)
    stats1 = (args[2] / slots).expand(-1, slots, -1).contiguous()
    args = (*args[:2], stats1, *args[3:])
    name = "graph_update_grouped" if groups else "graph_update"
    got, want = _wide_call(name, args)
    assert got[1].shape == (6, lib.cmpc_graph_update_parts(n, 4104), 2)
    _close(name, got, want, n * 4104)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c,heads", [(2, 100, 4104, 5), (3, 25, 1030, 8),
                                         (1, 41, 2002, 5), (2, 64, 4098, 2),
                                         (2, 1600, 4104, 5),
                                         (2, 1681, 2002, 5)])
def test_mutan_bwd_dz_wide_form_matches_plain_version(cuda, b, n, c, heads):
    """heads * C past the dz kernel's ring: the wide form (dz, dlang, db)
    against the plain version; C = 4104 with 5 heads takes 16-byte rows,
    1030 with 8 and 2002 with 5 4-byte rows, 4098 with 2 8-byte rows;
    (2, 1600, 4104, 5) is phase 17's shape, N = 1681 and 41 are odd row
    counts a sample (row ranges cross samples).  The scratch holds the
    main kernel's slots for the wide form's row ranges, then (r, gy) per
    row."""
    v = torch.tanh(_rnd(cuda, b * n, heads * c, dtype=torch.float32))
    args = (v.to(torch.bfloat16),
            torch.tanh(_rnd(cuda, b, heads * c, dtype=torch.float32)),
            _rnd(cuda, b * n, c, scale=0.1))
    kw = {"heads": heads, "rows_per_sample": n}
    lib = build.library("mutan_bwd")
    assert lib.cmpc_mutan_dz_blocks(b * n, c, heads) == 0
    ranges = lib.cmpc_mutan_dz_wide_ranges(b * n, c, heads)
    assert 1 <= ranges <= b * n
    assert kernels.mutan_bwd_dz_scratch(b * n, n, c, heads) == (
        2 * ranges + b - 1 + -(-2 * b * n // (heads * c)), heads * c)
    got, want = _wide_call("mutan_bwd_dz", args, kw)
    _close("mutan_bwd_dz", got, want, None)


@pytest.mark.gpu
def test_mutan_bwd_dz_wide_form_takes_a_misaligned_lang(cuda):
    """The wide form reads lang in vectors of up to 16 bytes: a lang view
    that starts 4 bytes past a 16-byte bound gives the bits an aligned
    copy gives (the wrapper copies it)."""
    b, n, c, heads = 2, 25, 4104, 5
    v = torch.tanh(_rnd(cuda, b * n, heads * c, dtype=torch.float32))
    buf = torch.tanh(_rnd(cuda, b * heads * c + 1, dtype=torch.float32))
    lang = buf[1:].view(b, heads * c)
    assert lang.data_ptr() % 16
    args = (v.to(torch.bfloat16), lang, _rnd(cuda, b * n, c, scale=0.1))
    kw = {"heads": heads, "rows_per_sample": n}
    got, want = _wide_call("mutan_bwd_dz", args, kw)
    again = kernels.mutan_bwd_dz(args[0], lang.clone(), args[2], **kw)
    for a, w, r in zip(got, want, again):
        assert torch.equal(a, r)
    _close("mutan_bwd_dz", got, want, None)


@pytest.mark.gpu
def test_registry_shapes_take_the_main_kernels(cuda):
    """At the registry's widths (C = 1000, A = 1000, CM = 500; BERT's 1024,
    512, 512) every wrapper launches its main kernel, with the plan or
    cluster it took before the wide forms, and so do the widest shapes the
    main kernels take (A = 2048, CM = 1024, C = 4096 with T = 20): no wide
    launch."""
    aff = build.library("spa_affinity")
    assert aff.cmpc_spa_affinity_row_blocks(1600, 1000) == 13 * 4
    assert aff.cmpc_spa_affinity_row_blocks(1600, 512) == 13 * 2
    graph = build.library("graph_conv")
    assert graph.cmpc_graph_msg_smem(1000, 20) > 0
    assert graph.cmpc_graph_msg_smem(1024, 20) > 0
    assert graph.cmpc_graph_update_parts(1600, 1000) == 13 * 4
    assert build.library("mutan_bwd").cmpc_mutan_dz_blocks(
        8 * 1600, 1000, 5) >= 1
    kernels.reset_launch_counts()
    for name in ("mutan_bwd_dz", "spa_affinity", "spa_affinity_grouped",
                 "graph_msg", "graph_update", "graph_update_grouped"):
        args, kw, _ = _inputs(cuda, name)
        getattr(kernels, name)(*args, **kw)
    for c, a in ((1000, 1000), (1024, 512)):
        kernels.spa_affinity(*_affinity_args(cuda, 1, 1600, c, a, 20, 0),
                             scale=c ** 0.5, l2n=True, masked=True)
        kernels.graph_msg(*_msg_args(cuda, 3, 1600, 20, c))
        kernels.graph_update_grouped(*_update_args(cuda, 3, 1600, c, 3))
        kernels.mutan_bwd_dz(*_dz_args(cuda, 1, 1600, c)[0], heads=5,
                             rows_per_sample=1600)
    for cm in (500, 512):
        kernels.se_sum(*_se_args(cuda, 1, 1600, cm, 2))
    # the widest shapes each main kernel takes
    kernels.spa_affinity(*_affinity_args(cuda, 1, 100, 72, 2048, 20, 0),
                         scale=8.0, l2n=True, masked=True)
    kernels.se_sum(*_se_args(cuda, 1, 100, 1024, 2))
    kernels.graph_update(*_update_args(cuda, 1, 100, 4096, 0))
    kernels.graph_msg(*_msg_args(cuda, 1, 100, 20, 4096))
    torch.cuda.synchronize()
    assert set(kernels.wide_launch_counts().values()) == {0}
    launched = kernels.launch_counts()
    assert all(launched[name] for name in kernels.wide_launch_counts())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1600, 1681])
def test_graph_msg_repeats_bit_identically(cuda, n):
    """Two launches at the packed bs=1 shapes (3 samples, C = 1000, T =
    20) give the same msg and statistics bits (the statistics are summed
    in a fixed order, one slot per 32-row group), and the slots per
    sample are `cmpc_graph_msg_parts(N)`."""
    args = _msg_args(cuda, 3, n, 20, 1000)
    first = kernels.graph_msg(*args)
    again = kernels.graph_msg(*args)
    parts = build.library("graph_conv").cmpc_graph_msg_parts(n)
    assert parts == (n + 31) // 32
    assert first[1].shape == (3, parts, 2)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_graph_msg_raises_on_misaligned_or_noncontiguous(cuda):
    """pooled is read by TMA and w_aff by 1-D bulk copies: the wrapper
    raises on a base that is not 16-byte aligned or a non-contiguous
    tensor rather than launch."""
    w_aff, pooled = _msg_args(cuda, 2, 100, 17, 72)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.graph_msg(w_aff, _shifted(pooled))
    with pytest.raises(ValueError, match="16-byte"):
        kernels.graph_msg(_shifted(w_aff), pooled)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.graph_msg(w_aff, pooled.transpose(1, 2).contiguous()
                          .transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [100, 1600])
@pytest.mark.parametrize("c", [72, 1000])
def test_graph_update_wgmma_kernel_matches_plain_version(cuda, c, n, groups):
    """The TMA + wgmma update kernel in both forms (G = 0: ungrouped; G =
    2: the two-level configs' packed graph): C = 72 is one block of 256
    columns, C = 1000 a cluster of four whose last block ends inside its
    fourth box and whose K runs 15 full stages and 40 columns; 100- and
    1600-row samples leave the last 128-row tile part empty; 6 samples."""
    args = _update_args(cuda, 6, n, c, groups)
    name = "graph_update_grouped" if groups else "graph_update"
    wrapper = getattr(kernels, name)
    got = wrapper(*args)
    want = kernels.PLAIN[wrapper](*args)
    torch.cuda.synchronize()
    _close(name, got, want, n * c)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["se_sum", "convlstm_gates",
                                  "spa_affinity_grouped",
                                  "graph_update_grouped", "mutan_bwd_dz",
                                  "convlstm_raw"])
def test_kernel_repeats_bit_identically(cuda, name):
    """50 launches at the flagship's bs=1 shapes (the dz pass at bs=8's)
    give the same bits: a missing proxy fence between the cp.async copies
    (or the on-chip transform) and the wgmmas, a missing cluster barrier or
    a ring stage released too early shows as a result that changes now and
    then; the statistics and the dz pass's slot sums are in fixed order."""
    kw = {}
    if name == "mutan_bwd_dz":
        args, kw = _dz_args(cuda, 8, 1600, 1000)
    elif name == "convlstm_raw":
        args = _raw_args(cuda, 1, 1600, 500)
    elif name == "se_sum":
        args = _se_args(cuda, 1, 1600, 500, 2)
    elif name == "convlstm_gates":
        args = _gates_args(cuda, 1, 1600, 500)
    elif name == "spa_affinity_grouped":
        args = _affinity_args(cuda, 3, 1600, 1000, 1000, 20, 3)
        kw = {"scale": 1000 ** 0.5, "l2n": False, "masked": True}
    else:
        args = _update_args(cuda, 3, 1600, 1000, 3)
    wrapper = getattr(kernels, name)
    first = wrapper(*args, **kw)
    first = first if isinstance(first, tuple) else (first,)
    for _ in range(49):
        again = wrapper(*args, **kw)
        again = again if isinstance(again, tuple) else (again,)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _shifted(t):
    """A copy of `t` whose data starts 2 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 8, dtype=t.dtype,
                      device=t.device)[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
def test_graph_tma_wrappers_raise_on_misaligned_or_noncontiguous(cuda):
    """The affinity and update kernels read x, the weights, wt and msg by
    TMA: their wrappers raise on a misaligned base or a non-contiguous
    tensor rather than launch."""
    args = list(_affinity_args(cuda, 2, 100, 72, 40, 6, 0))
    kw = {"scale": 8.0, "l2n": False, "masked": True}
    for i in (0, 1, 3):
        bad = list(args)
        bad[i] = _shifted(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            kernels.spa_affinity(*bad, **kw)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        kernels.spa_affinity(*bad, **kw)
    args = list(_update_args(cuda, 2, 100, 72, 0))
    for i in (0, 1, 3):
        bad = list(args)
        bad[i] = _shifted(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            kernels.graph_update(*bad)
    bad = list(args)
    bad[3] = args[3].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        kernels.graph_update(*bad)


@pytest.mark.gpu
def test_tma_wrappers_raise_on_misaligned_or_noncontiguous(cuda):
    """TMA needs 16-byte-aligned bases and contiguous rows: the mutan, dW,
    dz-pass (its bulk copies) and ConvLSTM gates wrappers raise on anything
    else rather than launch."""
    (x, w, b, lang), kw = _mutan_args(cuda, 72, 200, samples=2)
    m, k = x.shape
    shifted = torch.empty(m * k + 8, dtype=torch.bfloat16,
                          device="cuda")[1:1 + m * k].view(m, k)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.mutan_fused(shifted, w, b, lang, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.mutan_fused(x.t().contiguous().t(), w, b, lang, **kw)
    dz = _rnd(cuda, m, 360)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.mutan_dw(shifted, dz)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.mutan_dw(x, dz.t().contiguous().t())
    (v, lang_dz, g), dz_kw = _dz_args(cuda, 2, 25, 72)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.mutan_bwd_dz(_shifted(v), lang_dz, g, **dz_kw)
    args = _gates_args(cuda, 1, 25, 12)
    w = args[3]
    shifted_w = torch.empty(w.numel() + 8, dtype=torch.bfloat16,
                            device="cuda")[1:1 + w.numel()].view(w.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.convlstm_gates(*args[:3], shifted_w, *args[4:])


@pytest.mark.gpu
def test_wrapper_raises_on_wrong_dtype(cuda):
    args, _, _ = _inputs(cuda, "graph_msg")
    with pytest.raises(TypeError, match="bfloat16"):
        kernels.graph_msg(args[0].float(), args[1])


TINY = dict(H=32, W=32, num_steps=6, vocab_size=30, glove_dim=8,
            rnn_size=16, v_emb_dim=16, mlp_dim=12, batch_size=3,
            res4_blocks=2)


def _expected_launches(cfg, batch, train=False):
    """The launches of one forward (or train step) of `cfg` at `batch`:
    per level one mutan (the training form, the dz pass and dW when
    training), one ConvLSTM step and two SE sums (none for the self-gated
    exchange); the graph packed (one launch of each grouped kernel) or
    level by level (no affinity kernel under the double softmax)."""
    from cmpc_refseg_torch.models.cmpc import pack_levels
    levels = len(cfg.levels)
    packed = pack_levels(batch, levels, cfg.graph_norm)
    per_level = 0 if packed else levels
    affinity = cfg.graph_norm != "double_softmax"
    return {"mutan_fused": 0 if train else levels,
            **dict.fromkeys(("mutan_fwd_residual", "mutan_bwd_dz",
                             "mutan_dw"), levels if train else 0),
            "spa_affinity": per_level if affinity else 0,
            "spa_affinity_grouped": int(packed and affinity),
            "graph_msg": 1 if packed else levels, "graph_update": per_level,
            "graph_update_grouped": int(packed),
            "se_sum": 0 if cfg.exchange_self_gate else 2 * levels,
            "convlstm_gates": levels, "convlstm_raw": levels}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["CMPC_model", "CMPCv5_model",
                                  "CMPCv6_model"])
def test_small_forward_kernel_route_matches_plain_route(cuda, name):
    """A TINY bf16 forward on the card at batch 3: each kernel launches as
    often as the path needs (per level, or once per grouped kernel where
    the levels are packed: G = 3 for the flagship, 2 for CMPCv5_model's
    ASPP decoder config and for CMPCv6_model, whose self-gated exchange
    launches no SE sum) and sigm agrees with the plain route."""
    from cmpc_refseg_torch.api import build_model
    from cmpc_refseg_torch.models.model import apply_model
    model = build_model(name, dtype="bfloat16", **TINY)
    rng = np.random.default_rng(1)
    words = np.zeros((3, 6), np.int64)
    words[:, :4] = rng.integers(3, 30, (3, 4))
    batch = {"im": (20 * rng.standard_normal((3, 32, 32, 3))
                    ).astype(np.float32),
             "words": words, "seq_len": np.array([4, 2, 6])}
    kernels.reset_launch_counts()
    out = model.forward(batch)
    assert kernels.launch_counts() == _expected_launches(model.cfg, 3)
    with torch.inference_mode():
        ref = apply_model(model.params, model.cfg,
                          {k: torch.as_tensor(v, device="cuda")
                           for k, v in batch.items()},
                          model_state=model.model_state, use_kernels=False)
    assert torch.isfinite(out.sigm).all()
    assert (out.sigm - ref.sigm).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_small_train_step_kernel_route_matches_plain_route(cuda):
    """A TINY bf16 train step on the card at batch 3 (levels packed): the
    loss and each trainable gradient of the kernel route against the plain
    route (loss within 1e-2 relative, each leaf's gradient within 5e-2 in
    norm: the bf16 residual of mutan's backward is the known
    approximation), then one step through Trainer.step with the train
    path's launch counts."""
    from cmpc_refseg_torch.api import build_trainer
    from cmpc_refseg_torch.train.optimizer import named_leaves
    from cmpc_refseg_torch.train.trainer import compute_gradients
    trainer = build_trainer("CMPC_model", dtype="bfloat16", **TINY)
    rng = np.random.default_rng(2)
    words = np.zeros((3, 6), np.int64)
    words[:, :4] = rng.integers(3, 30, (3, 4))
    batch = {"im_u8": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
             "target_u8": (rng.random((3, 32, 32, 1)) > 0.6).astype(
                 np.uint8), "words": words, "seq_len": np.array([4, 2, 6])}
    state, cfg = trainer.state, trainer.cfg
    leaves = list(named_leaves(state.trainable))
    loss_k, _ = compute_gradients(state, cfg, batch)
    grads_k = [leaf.grad.clone() for _, leaf in leaves]
    loss_p, _ = compute_gradients(state, cfg, batch, use_kernels=False)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-2 * abs(loss_p.item())
    for (path, leaf), gk in zip(leaves, grads_k):
        assert torch.isfinite(gk).all(), path
        err = (gk.double() - leaf.grad.double()).norm()
        assert err <= 5e-2 * leaf.grad.double().norm(), path
    kernels.reset_launch_counts()
    metrics = trainer.step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss_total"]))
    assert kernels.launch_counts() == _expected_launches(cfg, 3, train=True)


# ---------------------------------------------------------------------------
# the f32-accumulating product (kernels.matmul_f32) on the tensor cores
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("sa,sb,transposed", [
    ((300, 136), (136, 72), False), ((3, 300, 136), (136, 72), False),
    ((3, 300, 136), (3, 136, 72), False), ((3, 300, 136), (3, 136, 72), True),
    ((4, 1600, 20), (4, 20, 1000), False)])
def test_matmul_f32_tensor_core_route_matches_the_widened_product(
        cuda, sa, sb, transposed):
    """bf16 CUDA operands through cuBLAS with an f32 result: the forward
    within 1e-5 of the widened f32 product (both sum exact products in
    f32, in other orders), and each gradient, from a bf16-exact
    cotangent, that of the widened product up to the rounding to its
    operand's bf16."""
    a = _rnd(cuda, *sa)
    b = (_rnd(cuda, *sb[:-2], sb[-1], sb[-2]).transpose(-1, -2)
         if transposed else _rnd(cuda, *sb))
    cot = _rnd(cuda, *sa[:-1], sb[-1]).float()
    x, y = a.detach().requires_grad_(), b.detach().requires_grad_()
    kernels.reset_launch_counts()
    out = kernels.matmul_f32(x, y)
    gx, gy = torch.autograd.grad(out, (x, y), cot)
    assert kernels.product_route_counts() == {"tensor_core": 1,
                                              "widened": 0}
    ref = a.float() @ b.float()
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    for grad, want in ((gx, cot @ b.float().mT), (gy, a.float().mT @ cot)):
        if want.dim() > grad.dim():     # b shared by a's batch
            want = want.sum(0)
        assert grad.dtype == torch.bfloat16
        torch.testing.assert_close(grad.float(), want, rtol=2 ** -8,
                                   atol=1e-5 * want.abs().max().item())


# f32 GEMMs off the tensor cores: cuBLAS's SIMT and FP32 xmma kernels
F32_GEMM = re.compile(r"sgemm|(?<!implicit_)gemm_f32f32", re.I)


@pytest.mark.gpu
def test_small_train_step_recompute_runs_no_f32_gemm(cuda, monkeypatch):
    """A TINY bf16 flagship train step on the card: every `matmul_f32` call
    with two bf16 operands goes to the tensor cores and every other call
    widens (here only the f32 logits and pooled vector, called with f32
    operands); inside ``cmpc.backward`` the head ops' recomputed plain
    routes (`ops.autograd._Recompute.backward`, marked here by a
    ``cmpc.recompute`` range) run bf16 tensor-core GEMMs, and f32 GEMMs
    only for their widened calls: at most three (the product and its two
    gradients) each.  The f32 GEMMs elsewhere in the backward, listed on
    failure, are the f32 products of the precision policy (the LSTM, the
    parser, the global vector, the logits' resize)."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    from cmpc_refseg_torch.api import build_trainer
    from cmpc_refseg_torch.models import cmpc
    from cmpc_refseg_torch.ops import autograd
    from cmpc_refseg_torch.utils.profile_forward import stage_kernels
    recompute, product = autograd._Recompute.backward, kernels.matmul_f32
    inside, calls = [0], []     # (in the recompute, widened) per call

    def marked(ctx, *grads):
        inside[0] += 1
        try:
            with record_function("cmpc.recompute"):
                return recompute(ctx, *grads)
        finally:
            inside[0] -= 1

    def counted(a, b):
        calls.append((inside[0] > 0,
                      not a.dtype == b.dtype == torch.bfloat16))
        return product(a, b)
    monkeypatch.setattr(autograd._Recompute, "backward", staticmethod(marked))
    for module in (kernels, cmpc):
        monkeypatch.setattr(module, "matmul_f32", counted)
    trainer = build_trainer("CMPC_model", dtype="bfloat16", **TINY)
    rng = np.random.default_rng(2)
    words = np.zeros((3, 6), np.int64)
    words[:, :4] = rng.integers(3, 30, (3, 4))
    batch = {"im_u8": rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8),
             "target_u8": (rng.random((3, 32, 32, 1)) > 0.6).astype(
                 np.uint8), "words": words, "seq_len": np.array([4, 2, 6])}
    trainer.step(batch)
    kernels.reset_launch_counts()
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    widened = [w for _, w in calls]
    assert kernels.product_route_counts() == {
        "tensor_core": widened.count(False), "widened": widened.count(True)}
    stages = stage_kernels(prof, 1)
    ops = stages["cmpc.recompute"]
    f32 = sum(n for name, (_, n) in ops.items() if F32_GEMM.search(name))
    left = sorted(n for n in stages["cmpc.backward"] if F32_GEMM.search(n))
    assert f32 <= 3 * calls.count((True, True)), (sorted(ops), left)
    assert any(re.search(r"gemm.*bf16|nvjet", n) for n in ops), sorted(ops)
    assert calls.count((True, False)) > calls.count((True, True))


# ---------------------------------------------------------------------------
# the HSV mutan's K = 1011 and the BERT widths
# ---------------------------------------------------------------------------

def _hsv_mutan(g, b=2, side=10, c=1000, k_spatial=11):
    """A level's mutan at the HSV configs' widths: C = 1000 and K = C + 11
    = 1011, which apply_mutan pads to 1016 (params f32, the visual input
    bf16, the text feature f32)."""
    f32 = torch.float32
    k = c + k_spatial
    params = {"vis_trans": {"DW": _rnd(g, 1, 1, k, 5 * c, dtype=f32,
                                       scale=(6 / (k + 5 * c)) ** 0.5),
                            "biases": _rnd(g, 5 * c, dtype=f32, scale=0.1)},
              "lang_trans": {"DW": _rnd(g, 1, 1, c, 5 * c, dtype=f32,
                                        scale=0.03),
                             "biases": _rnd(g, 5 * c, dtype=f32,
                                            scale=0.1)}}
    return (params, _rnd(g, b, 1, 1, c, dtype=f32),
            _rnd(g, b, side, side, k_spatial), _rnd(g, b, side, side, c))


@pytest.mark.gpu
def test_apply_mutan_pads_k_on_the_card(cuda):
    """K = 1011 through the mutan kernel: apply_mutan's kernel route, from
    the weight padded on the fly and from prepare_params' padded w_wide,
    against its plain route (one launch each, no ValueError)."""
    from cmpc_refseg_torch.models import cmpc
    params, lang, spatial, vis = _hsv_mutan(cuda)
    wide = cmpc.pad_mutan_weight(params["vis_trans"]["DW"][0, 0]).to(
        torch.bfloat16).contiguous()
    assert wide.shape == (1016, 5000)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = cmpc.apply_mutan(params, lang, spatial, vis)
        again = cmpc.apply_mutan({**params, "w_wide": wide}, lang, spatial,
                                 vis)
        want = cmpc.apply_mutan(params, lang, spatial, vis,
                                use_kernels=False)
    torch.cuda.synchronize()
    assert kernels.mutan_fused.launches == 2
    assert torch.equal(got, again)
    _close("mutan_fused", got, want, None)


@pytest.mark.gpu
def test_mutan_training_form_pads_k_on_the_card(cuda):
    """The training form at K = 1011: the residual forward, the dz pass and
    the dW kernel (at K = 1016) each launch once; the output and the
    gradients of the visual input, the weight (its leaf keeps [1, 1, 1011,
    5000]), the bias and the text feature against autograd of the plain
    route, each within 5e-2 in norm (the bf16 residual v is the known
    approximation)."""
    from cmpc_refseg_torch.models import cmpc
    params, lang, spatial, vis = _hsv_mutan(cuda)
    leaves = [params["vis_trans"]["DW"], params["vis_trans"]["biases"],
              lang, vis]
    cot = _rnd(cuda, *vis.shape, scale=1e-2)
    outs, grads = [], []
    for use_kernels in (True, False):
        for t in leaves:
            t.grad = None
            t.requires_grad_()
        kernels.reset_launch_counts()
        out = cmpc.apply_mutan(params, lang, spatial, vis,
                               use_kernels=use_kernels)
        out.backward(cot)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert all(counts[k] == int(use_kernels) for k in (
            "mutan_fwd_residual", "mutan_bwd_dz", "mutan_dw"))
        outs.append(out.detach())
        grads.append([t.grad.double() for t in leaves])
    _close("mutan_fwd_residual", outs[0], outs[1], None)
    assert grads[0][0].shape == (1, 1, 1011, 5000)
    for gk, gp in zip(*grads):
        assert torch.isfinite(gk).all()
        assert (gk - gp).norm() <= 5e-2 * gp.norm()


def _bert_inputs(g, name, n=100, t=20):
    """A kernel's inputs at CMPCv4_BERT_model's widths (`config.py`:
    v_emb_dim 1024, mlp_dim 512, vw_emb_dim 512; the mutan's K = 1032 and
    its lang 5 x 1024 = 5120 wide; two levels, so the grouped kernels take
    G = 2 and the SE sum one other), 2 samples of n rows:
    (args, kwargs, entries per sample behind its statistics)."""
    b, c, a, cm, f32 = 2, 1024, 512, 512, torch.float32
    mutan = ((_rnd(g, b * n, c + 8), _rnd(g, c + 8, 5 * c, scale=0.03),
              _rnd(g, 5 * c, dtype=f32, scale=0.1),
              torch.tanh(_rnd(g, b, 5 * c, dtype=f32))),
             {"heads": 5, "rows_per_sample": n})
    if name in ("mutan_fused", "mutan_fwd_residual"):
        return (*mutan, None)
    if name in ("mutan_bwd_dz", "mutan_dw"):
        _, v = kernels.mutan_fwd_residual_plain(*mutan[0], **mutan[1])
        dz_args = (v, mutan[0][3], _rnd(g, b * n, c, scale=0.1))
        if name == "mutan_bwd_dz":
            return (dz_args, mutan[1], None)
        dz, _, _ = kernels.mutan_bwd_dz_plain(*dz_args, **mutan[1])
        return (mutan[0][0], dz), {}, None
    mask = torch.ones(2 * b, 1, t, device="cuda")
    mask[:, :, 9:] = 0
    w_aff = torch.softmax(_rnd(g, 2 * b, n, t, dtype=f32), -1).to(
        torch.bfloat16)
    if name == "spa_affinity_grouped":
        return ((_rnd(g, 2 * b, n, c), _rnd(g, 2, c, a, scale=c ** -0.5),
                 _rnd(g, 2, a, scale=0.1), _rnd(g, 2 * b, t, a),
                 torch.rand(2 * b, 1, t, generator=g, device="cuda"), mask),
                {"scale": c ** 0.5, "l2n": False, "masked": False}, None)
    if name == "graph_msg":
        return (w_aff, _rnd(g, 2 * b, t, c)), {}, n * c
    if name == "graph_update_grouped":
        msg, st = kernels.graph_msg_plain(w_aff, _rnd(g, 2 * b, t, c))
        return ((_rnd(g, 2 * b, n, c), msg, st,
                 _rnd(g, 2, c, c, scale=c ** -0.5), _rnd(g, 2, c, scale=0.1),
                 1 + _rnd(g, 2, c, dtype=f32, scale=0.1),
                 _rnd(g, 2, c, dtype=f32, scale=0.1)), {}, n * c)
    if name == "se_sum":
        return ((_rnd(g, b, n, cm), [_rnd(g, b, n, cm)],
                 [torch.sigmoid(_rnd(g, b, cm))],
                 [_rnd(g, cm, cm, scale=cm ** -0.5)],
                 [_rnd(g, cm, scale=0.1)]), {}, None)
    x, h, cell = (_rnd(g, b, n, cm) for _ in range(3))
    w = _rnd(g, 2 * cm, 4 * cm, scale=(2 * cm) ** -0.5)
    ci, cf, co = (_rnd(g, n, cm, scale=0.2) for _ in range(3))
    if name == "convlstm_gates":
        return (x, h, cell, w, ci, cf), {}, n * cm
    gates, st = kernels.convlstm_gates_plain(x, h, cell, w, ci, cf)
    return ((gates, cell, co, st, 1 + _rnd(g, 5, cm, dtype=f32, scale=0.1),
             _rnd(g, 5, cm, dtype=f32, scale=0.1)), {}, n * cm)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "mutan_fused", "mutan_fwd_residual", "mutan_bwd_dz", "mutan_dw",
    "spa_affinity_grouped", "graph_msg", "graph_update_grouped", "se_sum",
    "convlstm_gates", "convlstm_raw"])
def test_kernel_at_bert_widths_matches_plain_version(cuda, name):
    """Each kernel at the BERT config's widths, where C = 512 and 1024 fill
    the kernels' column tiles exactly and the dz pass sits at its
    `heads <= 8, C <= 1024` edge, against its plain version (dW also
    against torch.mm, within 1e-3)."""
    args, kw, count = _bert_inputs(cuda, name)
    wrapper = getattr(kernels, name)
    before = wrapper.launches
    got = wrapper(*args, **kw)
    want = kernels.PLAIN[wrapper](*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _close(name, got, want, count)
    if name == "mutan_dw":
        ref = torch.mm(args[0].t(), args[1], out_dtype=torch.float32)
        assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


# ---------------------------------------------------------------------------
# any width: models/cmpc.py pads the kernels' operands
# ---------------------------------------------------------------------------

ODD_C, ODD_A, ODD_CM = 37, 29, 21     # padded to 40, 32, 24


def _odd_case(g, name):
    """(the padding function on CUDA tensors, the unpadded plain function,
    the kernels it must launch) at odd widths, 2 samples of 10 x 10."""
    from cmpc_refseg_torch.models import cmpc
    bf, b, side, t = torch.bfloat16, 2, 10, 7
    n = side * side

    def f32(*shape, scale=1.0):
        return _rnd(g, *shape, dtype=torch.float32, scale=scale)

    if name == "apply_mutan":
        c, k = ODD_C, ODD_C + 8
        p = {"vis_trans": {"DW": f32(1, 1, k, 5 * c, scale=0.1),
                           "biases": f32(5 * c, scale=0.1)},
             "lang_trans": {"DW": f32(1, 1, 16, 5 * c, scale=0.2),
                            "biases": f32(5 * c, scale=0.1)}}
        vis, spatial = _rnd(g, b, side, side, c), f32(b, side, side, 8)
        lang = f32(b, 1, 1, 16)
        x = torch.cat([vis, spatial.to(bf)], -1).reshape(b * n, k)
        lt = torch.tanh(lang.reshape(b, 16) @ p["lang_trans"]["DW"][0, 0]
                        + p["lang_trans"]["biases"])
        want = kernels.mutan_plain(x, p["vis_trans"]["DW"][0, 0].to(bf),
                                   p["vis_trans"]["biases"], lt, heads=5,
                                   rows_per_sample=n)
        return (lambda: cmpc.apply_mutan(p, lang, spatial, vis).reshape(
            b * n, c)), want, {"mutan_fused"}
    if name in ("affinity", "graph_conv"):
        c, a = ODD_C, ODD_A
        x = _rnd(g, 2 * b, n, c)
        wgs, bgs = _rnd(g, 2, c, a, scale=c ** -0.5), _rnd(g, 2, a,
                                                           scale=0.1)
        wt = _rnd(g, 2 * b, t, a)
        rel = torch.rand(2 * b, 1, t, generator=g, device="cuda")
        mask = torch.ones(2 * b, 1, t, device="cuda")
        kw = dict(scale=c ** 0.5, l2n=True, masked=True)
        w_aff, v_aff = kernels.spa_affinity_grouped_plain(x, wgs, bgs, wt,
                                                          rel, mask, **kw)
        if name == "affinity":
            return (lambda: torch.cat(cmpc.affinity(
                x, *cmpc.pad_projection(wgs, bgs), wt, rel, mask, **kw))), \
                torch.cat([w_aff, v_aff]), {"spa_affinity_grouped"}
        gps = [{"update": {"DW": f32(1, 1, c, c, scale=c ** -0.5),
                           "biases": f32(c, scale=0.1)},
                "feat_ln": {"gamma": 1 + f32(c, scale=0.1),
                            "beta": f32(c, scale=0.1)},
                "update_ln": {"gamma": 1 + f32(c, scale=0.1),
                              "beta": f32(c, scale=0.1)}} for _ in range(2)]
        return (lambda: cmpc.graph_conv(cmpc.stack_gconv(gps, bf), x, w_aff,
                                        v_aff)), \
            cmpc._graph_conv_grouped(gps, x, w_aff, v_aff), \
            {"graph_msg", "graph_update_grouped"}
    cm = ODD_CM
    if name == "se_sum":
        args = (_rnd(g, b, n, cm), [_rnd(g, b, n, cm)],
                [torch.sigmoid(f32(b, cm)).to(bf)],
                [_rnd(g, cm, cm, scale=cm ** -0.5)], [_rnd(g, cm, scale=0.1)])
        return (lambda: cmpc.se_sum(*args)), kernels.se_sum_plain(*args), \
            {"se_sum"}
    p = {"kernel": f32(1, 1, 2 * cm, 4 * cm, scale=(3 * cm) ** -0.5),
         **{f"W_{q}": f32(side, side, cm, scale=0.1)
            for q in ("ci", "cf", "co")},
         "ln": [{"gamma": 1 + f32(cm, scale=0.1), "beta": f32(cm, scale=0.1)}
                for _ in range(5)]}
    xs = [_rnd(g, b, side, side, cm) for _ in range(3)]
    # the plain step on the unpadded tables, counting cm columns
    tables = {"w": p["kernel"][0, 0].to(bf),
              **{k: p[f"W_{k}"].reshape(-1, cm).to(bf)
                 for k in ("ci", "cf", "co")},
              **{k: torch.stack([ln[k] for ln in p["ln"]])
                 for k in ("gamma", "beta")}}
    want = cmpc.convlstm_step_fused({**p, "tables": tables}, *xs,
                                    use_kernels=False)
    return (lambda: torch.cat(cmpc.convlstm_step_fused(p, *xs))), \
        torch.cat(want), {"convlstm_gates", "convlstm_raw"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["apply_mutan", "affinity", "graph_conv",
                                  "se_sum", "convlstm_step_fused"])
def test_padding_functions_take_odd_widths_on_the_card(cuda, name):
    """C 37, A 29, CM 21 (no multiple of 8): each padding function of
    models/cmpc.py launches its kernels, no ValueError, and matches the
    unpadded plain function (the graph convolution's layer norms two-pass
    on the plain side; the ConvLSTM's counting 21 columns)."""
    with torch.inference_mode():
        fn, want, names = _odd_case(cuda, name)
        kernels.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
    assert {k for k, v in kernels.launch_counts().items() if v} == names
    assert got.shape == want.shape
    _close(name, got, want, None)


# ---------------------------------------------------------------------------
# the command lines on the card
# ---------------------------------------------------------------------------

CLI_TINY = ["-H", "32", "-W", "32", "-T", "8", "-rnn_size", "16",
               "-v_emb_dim", "16", "-mlp_dim", "12", "-glove_dim", "8",
               "-res4_blocks", "2", "-vocab_size", "7"]


def _cli_tree(root, n=4):
    """A fake RefVOS tree: n 48x64 JPEG frames and RGB PNG masks."""
    import json
    import os

    from PIL import Image

    from cmpc_refseg_torch.data.refvos import OBJECT_COLOR
    for d in ("J", "A"):
        os.makedirs(os.path.join(root, d, "v"))
    rng = np.random.default_rng(0)
    meta = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(os.path.join(root, "J", "v", f"f{i}.jpg"))
        mask = np.zeros((48, 64, 3), np.uint8)
        mask[10:30, 20:50] = OBJECT_COLOR["1"]
        Image.fromarray(mask).save(os.path.join(root, "A", "v", f"f{i}.png"))
        meta.append([f"v/f{i}.jpg", f"v/f{i}.png", "the red box", "1"])
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(["<pad>", "<go>", "<eos>", "the", "red", "box",
                           "<unk>"]))
    return [os.path.join(root, p) for p in ("J", "A", "meta.json",
                                            "vocab.txt")]


@pytest.mark.gpu
def test_cli_runs_on_cuda_by_default(cuda, tmp_path):
    """No -device: the CLI trains on the card, in bf16, through the
    kernels."""
    from cmpc_refseg_torch import cli
    im_dir, mask_dir, meta, vocab = _cli_tree(str(tmp_path))
    kernels.reset_launch_counts()
    state = cli.main(["-m", "train", "-d", "refvos", "-im_dir", im_dir,
                      "-mask_dir", mask_dir, "-meta", meta, "-vocab", vocab,
                      "-emb_dir", str(tmp_path), "-bs", "2", "-st", "2",
                      "-s", "0", "-workers", "1",
                      "-ckpt_dir", str(tmp_path / "c"),
                      "-log_dir", str(tmp_path / "l")] + CLI_TINY)
    assert state.device.type == "cuda" and state.step == 2
    assert state.cfg.compute_dtype == "bfloat16"
    assert kernels.launch_counts()["mutan_fwd_residual"] > 0


@pytest.mark.gpu
def test_export_program_round_trips_on_the_card(cuda, tmp_path):
    """The exported plain route, saved and loaded, gives the masks of
    `make_predict_fn` on the card (float32: the same ops)."""
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.models.model import init_model, init_model_state
    from cmpc_refseg_torch.serving import export
    cfg = get_config("CMPC_model", H=32, W=32, num_steps=8, rnn_size=16,
                     v_emb_dim=16, mlp_dim=12, glove_dim=8, res4_blocks=2,
                     vocab_size=7, compute_dtype="float32")
    params = init_model(0, cfg, device="cuda")
    state = init_model_state(cfg, device="cuda")
    path = str(tmp_path / "p.pt2")
    export.export_program(cfg, params, state, path, batch_size=2)
    feed = (torch.randn(2, 32, 32, 3, generator=cuda, device="cuda") * 50,
            torch.tensor([[3, 4, 5, 0, 0, 0, 0, 0], [5, 3, 0, 0, 0, 0, 0, 0]],
                         device="cuda"),
            torch.tensor([3, 2], device="cuda"))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = export.load_program(path)(*feed)
        want = export.make_predict_fn(cfg, params, state)(*feed)
    assert got.device.type == "cuda" and got.shape == (2, 32, 32)
    assert not any(kernels.launch_counts().values())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_spawned_reader_workers_never_touch_cuda(cuda, tmp_path):
    """RefVOSReader's spawned workers, started from a process that holds a
    CUDA context, map neither torch nor libcuda."""
    from cmpc_refseg_torch.data.refvos import RefVOSReader
    torch.ones(1, device="cuda")
    reader = RefVOSReader(*_cli_tree(str(tmp_path)), T=8, input_h=32,
                          input_w=32, num_workers=2)
    try:
        batch = reader.read_collated(4)
        assert batch["im_batch"].shape == (4, 32, 32, 3)
        for proc in reader._reader._procs:
            assert proc.is_alive()
            with open(f"/proc/{proc.pid}/maps") as f:
                maps = f.read()
            assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        reader.close()
    assert not any(p.is_alive() for p in reader._reader._procs)


VIDEO_TINY = dict(TINY, batch_size=2, num_frames=8,
                  sampled_frames=(0, 2, 4, 6, 7))


@pytest.mark.gpu
def test_small_video_forward_kernel_route_matches_plain_route(cuda):
    """A TINY bf16 video forward on the card at 2 clips of 8 frames: the
    mutan per level once over each clip's 5 sampled frames (2 samples of
    5 * 4 * 4 rows), the center frame's spatial graph packed, the fusion
    stack at batch 2; sigm within 2e-2 of the plain route's."""
    from cmpc_refseg_torch.api import build_model
    from cmpc_refseg_torch.models.model import apply_model
    model = build_model("CMPC_video_mm_tgraph_allvec", dtype="bfloat16",
                        **VIDEO_TINY)
    rng = np.random.default_rng(3)
    words = np.zeros((2, 6), np.int64)
    words[:, 2:] = rng.integers(3, 30, (2, 4))
    batch = {"clip": (20 * rng.standard_normal((2, 8, 32, 32, 3))
                      ).astype(np.float32),
             "words": words, "valid_idx": np.array([2, 2])}
    kernels.reset_launch_counts()
    out = model.forward(batch)
    assert kernels.launch_counts() == _expected_launches(model.cfg, 2)
    with torch.inference_mode():
        ref = apply_model(model.params, model.cfg,
                          {k: torch.as_tensor(v, device="cuda")
                           for k, v in batch.items()}, use_kernels=False)
    assert out.sigm.shape == (2, 32, 32, 1) and torch.isfinite(out.sigm).all()
    assert (out.sigm - ref.sigm).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,sxy", [(320, 320, 3.0), (45, 61, 1.5)])
def test_mean_field_gaussian_on_the_card_matches_the_cpu(cuda, h, w, sxy):
    """The on-device mean field (cuDNN's conv1d, f32 with TF32 off)
    within 1e-5 of the same function on the CPU."""
    from cmpc_refseg_torch.ops.densecrf import mean_field_gaussian
    p = torch.rand(2, h, w, generator=cuda, device="cuda") * 0.98 + 0.01
    got = mean_field_gaussian(p, sxy=sxy)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), mean_field_gaussian(p.cpu(),
                                                              sxy=sxy),
                               rtol=0, atol=1e-5)


# the int8 backbone's shape classes: (ksize, stride, dilation, cin, cout)
INT8_CLASSES = {"conv1 7x7/2, K 147 -> 152": (7, 2, 1, 3, 64),
                "1x1": (1, 1, 1, 64, 256), "1x1/2": (1, 2, 1, 256, 128),
                "3x3": (3, 1, 1, 64, 64), "3x3 dilation 2": (3, 1, 2, 128, 64),
                "3x3 dilation 4": (3, 1, 4, 64, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(INT8_CLASSES))
def test_int8_gemm_conv_equals_float64_conv(cuda, name):
    """`int8_conv_gemm` (torch._int_mm on the channels_last rows, the
    im2col for k x k) bit-equal to the exact float64 conv of the same int8
    codes, per shape class of the backbone, at ragged 17 x 19 maps."""
    from cmpc_refseg_torch.models import backbone as bb
    k, stride, dilation, cin, cout = INT8_CLASSES[name]
    xq = torch.randint(-127, 128, (2, cin, 17, 19), generator=cuda,
                       device="cuda", dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=cuda,
                        device="cuda", dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    w_gemm = bb.gemm_weight(w_q)
    assert w_gemm.shape[1] % 8 == 0
    got = bb.int8_conv_gemm(xq, w_gemm, ksize=k, stride=stride,
                            dilation=dilation)
    want = bb.int8_conv_plain(xq, w_q, stride=stride, dilation=dilation)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_int8_gemm_refuses_what_int_mm_refuses(cuda):
    """A product `torch._int_mm` refuses (here 4 rows: it wants more than
    16) raises; the unit never falls back to floating point."""
    from cmpc_refseg_torch.models import backbone as bb
    w_q = torch.ones((64, 64, 1, 1), device="cuda", dtype=torch.int8)
    xq = torch.ones((1, 64, 2, 2), device="cuda", dtype=torch.int8)
    with pytest.raises(RuntimeError):
        bb.int8_conv_gemm(xq, bb.gemm_weight(w_q), ksize=1)


@pytest.mark.gpu
def test_two_rank_dp_step_on_the_card_matches_one_process(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (spawned; tests/torch_parallel_worker.py)
    take one bf16 DP step of the TINY flagship on the halves of a batch of
    4: both ranks hold bit-equal weights after it, and against one
    process's step on the whole batch the loss is within 1e-2 relative
    and the all-reduced gradient within 5e-2 of the single gradient's
    norm (bf16 sums over other rows: chip_smoke.py holds it leaf by leaf
    at full size)."""
    import multiprocessing as mp

    import torch_parallel_worker as worker
    from cmpc_refseg_torch.config import get_config
    from cmpc_refseg_torch.train import trainer as ttrain
    from cmpc_refseg_torch.train.optimizer import named_leaves
    geo = dict(TINY, batch_size=4, compute_dtype="bfloat16")
    rng = np.random.default_rng(4)
    words = np.zeros((4, 6), np.int64)
    for i, n in enumerate((2, 5, 6, 1)):
        words[i, :n] = rng.integers(3, 30, n)
    batch = {"im_u8": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "target_u8": (rng.random((4, 32, 32, 1)) > 0.7).astype(np.uint8),
             "words": words, "seq_len": np.array([2, 5, 6, 1])}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=worker.gpu_step, args=(
        r, str(tmp_path / "init"), geo, batch, results)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        ranks = dict(results.get(timeout=300) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in procs)
    assert all(not isinstance(r, str) for r in ranks.values()), ranks
    np.testing.assert_array_equal(ranks[0]["weights"], ranks[1]["weights"])
    cfg = get_config("CMPC_model", **geo)
    state = ttrain.create_train_state(0, cfg, device="cuda")
    loss = float(ttrain.make_train_step(cfg)(state, batch)["loss_total"])
    grad = torch.cat([p.grad.reshape(-1) for _, p in
                      named_leaves(state.trainable)]).double().cpu().numpy()
    assert abs(ranks[0]["loss"] - loss) <= 1e-2 * abs(loss)
    assert np.linalg.norm(ranks[0]["grad"] - grad) \
        <= 5e-2 * np.linalg.norm(grad)
