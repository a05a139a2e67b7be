"""`ops.kernels.matmul_f32`, the head's one f32-accumulating product, on the
CPU.

- On the CPU it is the widened product ``a.float() @ b.float()``, forward
  and gradients bit for bit, for bf16, f32 and mixed operands that are
  2-D, 3-D, a batch against a shared matrix, or transposed views; each
  call counts as 'widened' (`kernels.product_route_counts`).
- Its cuBLAS route (`_MatmulF32`, bf16 on the card) on the meta device:
  an f32 result, and each gradient in its operand's dtype and shape.
- The plain versions of the affinity, the graph convolution, the SE sum
  and the ConvLSTM gates, and the head's plain graph convolution, take
  every product through it.
"""

import math

import pytest
import torch

from cmpc_refseg_torch.models import cmpc
from cmpc_refseg_torch.ops import kernels

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
# name: (a's shape, b's shape, b stored transposed)
SHAPES = {"2d": ((7, 12), (12, 5), False),
          "3d": ((3, 7, 12), (3, 12, 5), False),
          "shared": ((3, 7, 12), (12, 5), False),
          "4d_shared": ((2, 3, 7, 12), (12, 5), False),
          "3d_transposed": ((3, 7, 12), (3, 12, 5), True)}
DTYPES = {"bf16": (BF16, BF16), "f32": (F32, F32), "mixed": (F32, BF16)}


def _operand(g, shape, dtype, transposed=False, device="cpu"):
    if transposed:     # a [.., N, K] tensor read as its [.., K, N] view
        return _operand(g, (*shape[:-2], shape[-1], shape[-2]), dtype,
                        device=device).transpose(-1, -2)
    return torch.randn(*shape, generator=g).to(dtype).to(device)


def _grads(fn, a, b, cot):
    a = a.detach().requires_grad_()
    b = b.detach().requires_grad_()
    out = fn(a, b)
    out.backward(cot)
    return out.detach(), a.grad, b.grad


@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matmul_f32_is_the_widened_product_on_the_cpu(shape, dtypes):
    g = torch.Generator().manual_seed(0)
    (sa, sb, tb), (da, db) = SHAPES[shape], DTYPES[dtypes]
    a, b = _operand(g, sa, da), _operand(g, sb, db, tb)
    cot = torch.randn(*torch.broadcast_shapes(sa[:-2], sb[:-2]), sa[-2],
                      sb[-1], generator=g)
    kernels.reset_launch_counts()
    got = _grads(kernels.matmul_f32, a, b, cot)
    assert kernels.product_route_counts() == {"tensor_core": 0,
                                              "widened": 1}
    want = _grads(lambda x, y: x.float() @ y.float(), a, b, cot)
    assert got[0].dtype == F32
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tensor_core_route_keeps_dtypes_and_shapes_on_meta(shape):
    """`_MatmulF32` (torch.mm / torch.bmm with out_dtype, which have meta
    kernels): f32 out, gradients in bf16 at their operands' shapes, for
    the shapes `matmul_f32` gives it."""
    sa, sb, tb = SHAPES[shape]
    if len(sb) == 2:        # matmul_f32 folds a's leading axes into rows
        sa = (math.prod(sa[:-1]), sa[-1])
    a = torch.empty(sa, dtype=BF16, device="meta", requires_grad=True)
    b = _operand(None, sb, BF16, tb, device="meta").requires_grad_()
    out = kernels._MatmulF32.apply(a, b)
    assert out.dtype == F32
    assert out.shape == (*a.shape[:-1], b.shape[-1])
    ga, gb = torch.autograd.grad(out, (a, b), torch.empty_like(out))
    assert (ga.dtype, gb.dtype) == (BF16, BF16)
    assert ga.shape == a.shape and gb.shape == b.shape


def _r(g, *shape, dtype=F32):
    return torch.randn(*shape, generator=g).to(dtype)


def _plain_calls(g, name):
    """(function, args, kwargs, its products) for one plain version at a
    small shape: B = 2 samples of N = 10 rows, C = 8, A = 6, T = 4."""
    b, n, c, a, t = 2, 10, 8, 6, 4
    mask = torch.ones(b, 1, t)
    if name == "spa_affinity_plain":
        return (kernels.spa_affinity_plain,
                (_r(g, b, n, c), _r(g, c, a), _r(g, a), _r(g, b, t, a),
                 torch.rand(b, 1, t, generator=g), mask),
                {"scale": 2.0, "l2n": True, "masked": True}, 2)
    if name == "graph_msg_plain":
        return kernels.graph_msg_plain, (_r(g, b, n, t), _r(g, b, t, c)), \
            {}, 1
    if name == "graph_update_plain":
        msg, st = kernels.graph_msg_plain(_r(g, b, n, t), _r(g, b, t, c))
        return (kernels.graph_update_plain,
                (_r(g, b, n, c), msg, st, _r(g, c, c), _r(g, c), _r(g, c),
                 _r(g, c)), {}, 1)
    if name == "se_sum_plain":
        k = 3
        return (kernels.se_sum_plain,
                (_r(g, b, n, c), [_r(g, b, n, c) for _ in range(k)],
                 [_r(g, b, c) for _ in range(k)],
                 [_r(g, c, c) for _ in range(k)],
                 [_r(g, c) for _ in range(k)]), {}, k)
    if name == "convlstm_gates_plain":
        return (kernels.convlstm_gates_plain,
                (_r(g, b, n, c), _r(g, b, n, c), _r(g, b, n, c),
                 _r(g, 2 * c, 4 * c), _r(g, n, c), _r(g, n, c)), {}, 1)
    gp = {"update": {"DW": _r(g, 1, 1, c, c), "biases": _r(g, c)},
          "feat_ln": {"gamma": _r(g, c), "beta": _r(g, c)},
          "update_ln": {"gamma": _r(g, c), "beta": _r(g, c)}}
    return (cmpc._graph_conv,
            (gp, _r(g, b, n, c), _r(g, b, n, t).softmax(-1),
             _r(g, b, n, t).softmax(1)), {}, 2)


@pytest.mark.parametrize("name", [
    "spa_affinity_plain", "graph_msg_plain", "graph_update_plain",
    "se_sum_plain", "convlstm_gates_plain", "cmpc._graph_conv"])
def test_plain_versions_take_every_product_through_matmul_f32(name,
                                                              monkeypatch):
    """Each product is one `matmul_f32` call (widened on the CPU), and the
    function's output is what it is with the widened product spelled out
    in its place."""
    fn, args, kw, products = _plain_calls(torch.Generator().manual_seed(1),
                                          name)
    kernels.reset_launch_counts()
    out = fn(*args, **kw)
    assert kernels.product_route_counts() == {"tensor_core": 0,
                                              "widened": products}
    monkeypatch.setattr(kernels, "matmul_f32",
                        lambda a, b: a.float() @ b.float())
    monkeypatch.setattr(cmpc, "matmul_f32",
                        lambda a, b: a.float() @ b.float())
    want = fn(*args, **kw)
    for x, y in zip(out if isinstance(out, tuple) else (out,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(x, y)
