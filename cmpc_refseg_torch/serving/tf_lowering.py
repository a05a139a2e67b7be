"""Lower a `torch.export` program of the plain route into TensorFlow.

`export.export_savedmodel` traces `make_predict_fn` with `torch.export`
(an ATen graph, the weights lifted as constants) and hands the program to
`lower`, which returns a `tf.Module` whose `tf.function` replays the graph
node by node with TensorFlow ops.  Every lifted tensor becomes a
`tf.Variable` of the module, so a SavedModel keeps the weights under
`variables/` and not in its GraphDef.

The lowering is a table (`_table`) from an ATen overload's name to a
function of the node's arguments (the graph's tensors as TF tensors, the
rest as the Python values the graph holds).  The table covers what the
plain route of the image configs that take words traces to; an op outside
it raises `NotImplementedError` naming it, and nothing falls back
silently.  Layouts: ATen's convolutions and max-pools are NCHW and TF's
CPU kernels take NHWC, so those two transpose around the TF op.  Dtypes
follow ATen's promotion for the mixed operands the graph holds (a Python
scalar takes the tensor's dtype; bool < integer < floating).

TensorFlow is imported by `lower` and the functions it calls, never when
this module is imported: the port runs on machines without it.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

_NO_OPS = ("aten._assert_tensor_metadata.default", "aten.alias.default",
           "aten.contiguous.default", "aten.lift_fresh_copy.default")


def _tf():
    import tensorflow as tf
    return tf


def tf_dtype(dtype):
    tf = _tf()
    return {torch.float32: tf.float32, torch.float64: tf.float64,
            torch.float16: tf.float16, torch.bfloat16: tf.bfloat16,
            torch.int64: tf.int64, torch.int32: tf.int32,
            torch.int16: tf.int16, torch.int8: tf.int8, torch.uint8: tf.uint8,
            torch.bool: tf.bool}[dtype]


def _is_tensor(v) -> bool:
    return hasattr(v, "dtype") and hasattr(v, "shape") and not isinstance(
        v, (np.ndarray, np.generic))


def _rank(dtype) -> int:
    return 0 if dtype.is_bool else 2 if dtype.is_floating else 1


def _promote(*vals):
    """`vals` (TF tensors and Python scalars) in ATen's result dtype of an
    elementwise op: the widest category of the tensors (bool < integer <
    floating), a floating scalar lifting integer or bool tensors to
    float32; within a category the wider dtype."""
    tf = _tf()
    tensors = [v for v in vals if _is_tensor(v)]
    if not tensors:
        return vals
    dt = tensors[0].dtype
    for t in tensors[1:]:
        if _rank(t.dtype) > _rank(dt) or (
                _rank(t.dtype) == _rank(dt) and t.dtype.size > dt.size):
            dt = t.dtype
    scalars = [v for v in vals if not _is_tensor(v)]
    if _rank(dt) < 2 and any(isinstance(s, float) for s in scalars):
        dt = tf.float32
    elif _rank(dt) == 0 and any(isinstance(s, int) and not isinstance(s, bool)
                                for s in scalars):
        dt = tf.int64
    return [tf.cast(v, dt) if _is_tensor(v) else tf.constant(v, dt)
            for v in vals]


def _binary(fn):
    """An elementwise ATen op of two operands (`alpha` scales the second:
    add, sub, rsub) in the promoted dtype."""
    def lowered(a, b, alpha=1):
        a, b = _promote(a, b)
        if alpha != 1:
            b = b * _tf().constant(alpha, b.dtype)
        return fn(a, b)
    return lowered


def _div(a, b):
    """True division: integer operands become float32, as in ATen."""
    tf = _tf()
    a, b = _promote(a, b)
    if not a.dtype.is_floating:
        a, b = tf.cast(a, tf.float32), tf.cast(b, tf.float32)
    return tf.math.truediv(a, b)


def _dim(d, ndim):
    return d + ndim if d < 0 else d


def _dims(dims, ndim):
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return None
    if isinstance(dims, int):
        return [_dim(dims, ndim)]
    return [_dim(d, ndim) for d in dims]


def _nchw(x):
    return _tf().transpose(x, [0, 2, 3, 1])


def _nhwc_to_nchw(x):
    return _tf().transpose(x, [0, 3, 1, 2])


def _pair(v):
    return list(v) * 2 if len(v) == 1 else list(v)


def _conv2d(x, w, bias=None, stride=(1, 1), padding=(0, 0),
            dilation=(1, 1), groups=1):
    tf = _tf()
    if groups != 1:
        raise NotImplementedError("aten.conv2d.default with groups != 1")
    if isinstance(padding, str):
        raise NotImplementedError(f"aten.conv2d.default padding={padding!r}")
    ph, pw = _pair(padding)
    y = tf.nn.conv2d(_nchw(x), tf.transpose(w, [2, 3, 1, 0]),
                     strides=[1, *_pair(stride), 1],
                     padding=[[0, 0], [ph, ph], [pw, pw], [0, 0]],
                     dilations=[1, *_pair(dilation), 1])
    if bias is not None:
        y = y + bias
    return _nhwc_to_nchw(y)


def _max_pool2d(x, kernel_size, stride=(), padding=(0, 0), dilation=(1, 1),
                ceil_mode=False):
    tf = _tf()
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride) if stride else (kh, kw)
    ph, pw = _pair(padding) if not isinstance(padding, int) else (padding,) * 2
    if _pair(dilation if not isinstance(dilation, int) else [dilation]) != \
            [1, 1]:
        raise NotImplementedError("aten.max_pool2d.default with dilation")
    h, w = x.shape[2], x.shape[3]

    def extra(size, k, s, p):
        out = (size + 2 * p - k) / s + 1
        n = int(np.ceil(out) if ceil_mode else np.floor(out))
        if ceil_mode and (n - 1) * s >= size + p:
            n -= 1
        return (n - 1) * s + k - (size + 2 * p)

    eh, ew = max(0, extra(h, kh, sh, ph)), max(0, extra(w, kw, sw, pw))
    y = tf.pad(_nchw(x), [[0, 0], [ph, ph + eh], [pw, pw + ew], [0, 0]],
               constant_values=float("-inf"))
    y = tf.nn.max_pool2d(y, [kh, kw], [sh, sw], "VALID")
    return _nhwc_to_nchw(y)


def _pad(x, pad, mode="constant", value=None):
    tf = _tf()
    if mode != "constant":
        raise NotImplementedError(f"aten.pad.default mode={mode!r}")
    nd = len(x.shape)
    pairs = [[0, 0] for _ in range(nd)]
    for i in range(len(pad) // 2):
        pairs[nd - 1 - i] = [pad[2 * i], pad[2 * i + 1]]
    # negative pads crop
    begin = [max(0, -lo) for lo, _ in pairs]
    size = [int(x.shape[d]) - begin[d] - max(0, -pairs[d][1])
            for d in range(nd)]
    if any(begin) or any(hi < 0 for _, hi in pairs):
        x = tf.slice(x, begin, size)
    pairs = [[max(0, lo), max(0, hi)] for lo, hi in pairs]
    return tf.pad(x, pairs, constant_values=tf.constant(
        0 if value is None else value, x.dtype))


def _expand(x, size):
    tf = _tf()
    lead = len(size) - len(x.shape)
    shape = [int(x.shape[i - lead]) if s == -1 else s
             for i, s in enumerate(size)]
    return tf.broadcast_to(x, shape)


def _repeat(x, repeats):
    tf = _tf()
    lead = len(repeats) - len(x.shape)
    if lead:
        x = tf.reshape(x, [1] * lead + list(x.shape))
    return tf.tile(x, repeats)


def _index(x, indices):
    """ATen's advanced indexing: one index tensor at one dim (the rest
    None), or index tensors at consecutive leading dims."""
    tf = _tf()
    live = [i for i, t in enumerate(indices) if t is not None]
    idx = [tf.cast(indices[i], tf.int64) for i in live]
    idx = [tf.where(t < 0, t + int(x.shape[d]), t) for t, d in zip(idx, live)]
    if len(live) == 1:
        return tf.gather(x, idx[0], axis=live[0])
    if live == list(range(len(live))):
        shape = idx[0].shape
        for t in idx[1:]:
            shape = tf.broadcast_static_shape(shape, t.shape)
        return tf.gather_nd(x, tf.stack([tf.broadcast_to(t, shape)
                                         for t in idx], axis=-1))
    raise NotImplementedError("aten.index.Tensor with index tensors at "
                              f"dims {live}")


def _slice(x, dim=0, start=None, end=None, step=1):
    tf = _tf()
    nd = len(x.shape)
    dim = _dim(dim, nd)
    size = int(x.shape[dim])
    start = 0 if start is None else start
    end = size if end is None else end
    start = min(max(start + size if start < 0 else start, 0), size)
    end = min(max(end + size if end < 0 else end, 0), size)
    begin = [0] * nd
    stop = [int(s) for s in x.shape]
    strides = [1] * nd
    begin[dim], stop[dim], strides[dim] = start, max(end, start), step
    return tf.strided_slice(x, begin, stop, strides)


def _select(x, dim, index):
    dim = _dim(dim, len(x.shape))
    if index < 0:
        index += int(x.shape[dim])
    return _tf().gather(x, index, axis=dim)


def _split(x, split_size, dim=0):
    dim = _dim(dim, len(x.shape))
    size = int(x.shape[dim])
    sizes = [split_size] * (size // split_size)
    if size % split_size:
        sizes.append(size % split_size)
    return _tf().split(x, sizes, axis=dim)


def _transpose(x, dim0, dim1):
    nd = len(x.shape)
    perm = list(range(nd))
    a, b = _dim(dim0, nd), _dim(dim1, nd)
    perm[a], perm[b] = perm[b], perm[a]
    return _tf().transpose(x, perm)


def _sum(x, dim=None, keepdim=False, dtype=None):
    tf = _tf()
    if x.dtype.is_bool or (x.dtype.is_integer and x.dtype != tf.int64):
        x = tf.cast(x, tf.int64)
    y = tf.reduce_sum(x, axis=_dims(dim, len(x.shape)), keepdims=keepdim)
    return tf.cast(y, tf_dtype(dtype)) if dtype is not None else y


def _mean(x, dim=None, keepdim=False, dtype=None):
    tf = _tf()
    if dtype is not None:
        x = tf.cast(x, tf_dtype(dtype))
    return tf.reduce_mean(x, axis=_dims(dim, len(x.shape)), keepdims=keepdim)


def _var_mean(x, dim=None, correction=None, keepdim=False):
    tf = _tf()
    axes = _dims(dim, len(x.shape)) or list(range(len(x.shape)))
    mean = tf.reduce_mean(x, axis=axes, keepdims=True)
    sq = tf.reduce_sum(tf.square(x - mean), axis=axes, keepdims=keepdim)
    n = int(np.prod([int(x.shape[a]) for a in axes]))
    var = sq / tf.constant(max(n - (1 if correction is None else correction),
                               0), x.dtype)
    return var, (mean if keepdim else tf.squeeze(mean, axis=axes))


def _matmul(a, b):
    tf = _tf()
    a, b = _promote(a, b)
    if len(a.shape) == 1 and len(b.shape) == 1:
        return tf.reduce_sum(a * b)
    if len(a.shape) == 1:
        return tf.squeeze(tf.matmul(a[None], b), axis=-2)
    if len(b.shape) == 1:
        return tf.squeeze(tf.matmul(a, b[:, None]), axis=-1)
    # batch dims broadcast by hand: TF 2.21's CPU BatchMatMul gives wrong
    # values where it broadcasts them itself ([2, 1, 16, 16] @ [16, 16])
    if len(b.shape) == 2:
        lead = list(a.shape[:-1])
        return tf.reshape(tf.matmul(tf.reshape(a, [-1, a.shape[-1]]), b),
                          lead + [b.shape[-1]])
    batch = tf.broadcast_static_shape(a.shape[:-2], b.shape[:-2]).as_list()
    return tf.matmul(tf.broadcast_to(a, batch + list(a.shape[-2:])),
                     tf.broadcast_to(b, batch + list(b.shape[-2:])))


def _where(cond, a, b):
    a, b = _promote(a, b)
    return _tf().where(cond, a, b)


def _like(fn):
    def lowered(x, dtype=None, **_):
        tf = _tf()
        return fn(x, dtype=tf_dtype(dtype) if dtype is not None else x.dtype)
    return lowered


def _new_zeros(x, size, dtype=None, **_):
    tf = _tf()
    return tf.zeros(size, tf_dtype(dtype) if dtype is not None else x.dtype)


def _arange(end, dtype=None, **_):
    tf = _tf()
    if dtype is None:
        dtype = torch.float32 if isinstance(end, float) else torch.int64
    return tf.range(end, dtype=tf_dtype(dtype))


def _to(x, *args, dtype=None, **_):
    """aten.to.device / to.dtype: a cast where a dtype is given (the device
    is the TF host's)."""
    tf = _tf()
    for a in args:
        if isinstance(a, torch.dtype):
            dtype = a
    return x if dtype is None else tf.cast(x, tf_dtype(dtype))


def _softmax(x, dim, half_to_float=False):
    return _tf().nn.softmax(x, axis=_dim(dim, len(x.shape)))


def _clamp(x, min=None, max=None):
    tf = _tf()
    if min is not None:
        x = tf.maximum(x, tf.constant(min, x.dtype))
    if max is not None:
        x = tf.minimum(x, tf.constant(max, x.dtype))
    return x


def _unsqueeze(x, dim):
    return _tf().expand_dims(x, _dim(dim, len(x.shape) + 1))


def _gather(x, dim, index, sparse_grad=False):
    tf = _tf()
    return tf.experimental.numpy.take_along_axis(
        x, tf.cast(index, tf.int64), axis=_dim(dim, len(x.shape)))


def _table() -> dict:
    tf = _tf()
    table = {name: (lambda x, *a, **k: x) for name in _NO_OPS}
    table.update({
        "aten.abs.default": tf.abs,
        "aten.add.Tensor": _binary(tf.add),
        "aten.addcmul.default": lambda x, a, b, value=1: _binary(tf.add)(
            x, _binary(tf.multiply)(a, b) * value),
        "aten.arange.default": _arange,
        "aten.cat.default": lambda ts, dim=0: tf.concat(
            _promote(*ts), axis=_dim(dim, len(ts[0].shape))),
        "aten.clamp.default": _clamp,
        "aten.conv2d.default": _conv2d,
        "aten.div.Tensor": _div,
        "aten.einsum.default": lambda eq, ts, path=None: tf.einsum(
            eq, *_promote(*ts)),
        "aten.eq.Scalar": _binary(tf.equal),
        "aten.eq.Tensor": _binary(tf.equal),
        "aten.exp.default": tf.exp,
        "aten.expand.default": lambda x, size, implicit=False: _expand(
            x, size),
        "aten.flip.default": lambda x, dims: tf.reverse(
            x, _dims(dims, len(x.shape))),
        "aten.gather.default": _gather,
        "aten.gt.Scalar": _binary(tf.greater),
        "aten.index.Tensor": _index,
        "aten.lt.Tensor": _binary(tf.less),
        "aten.matmul.default": _matmul,
        "aten.max_pool2d.default": _max_pool2d,
        "aten.maximum.default": _binary(tf.maximum),
        "aten.mean.dim": _mean,
        "aten.meshgrid.indexing": lambda ts, indexing="ij": tf.meshgrid(
            *ts, indexing=indexing),
        "aten.minimum.default": _binary(tf.minimum),
        "aten.mul.Tensor": _binary(tf.multiply),
        "aten.ne.Scalar": _binary(tf.not_equal),
        "aten.new_zeros.default": _new_zeros,
        "aten.ones_like.default": _like(tf.ones_like),
        "aten.pad.default": _pad,
        "aten.permute.default": lambda x, dims: tf.transpose(
            x, _dims(dims, len(x.shape))),
        "aten.promote_types.default": torch.promote_types,
        "aten.reciprocal.default": tf.math.reciprocal,
        "aten.relu.default": tf.nn.relu,
        "aten.relu_.default": tf.nn.relu,
        "aten.remainder.Scalar": _binary(tf.math.floormod),
        "aten.repeat.default": _repeat,
        "aten.reshape.default": tf.reshape,
        "aten.rsqrt.default": tf.math.rsqrt,
        "aten.rsub.Scalar": lambda x, other, alpha=1: _binary(tf.subtract)(
            other, x, alpha=alpha),
        "aten.select.int": _select,
        "aten.sigmoid.default": tf.sigmoid,
        "aten.slice.Tensor": _slice,
        "aten.softmax.int": _softmax,
        "aten.split.Tensor": _split,
        "aten.sqrt.default": tf.sqrt,
        "aten.stack.default": lambda ts, dim=0: tf.stack(
            _promote(*ts), axis=_dim(dim, len(ts[0].shape) + 1)),
        "aten.sub.Tensor": _binary(tf.subtract),
        "aten.sum.dim_IntList": _sum,
        "aten.tanh.default": tf.tanh,
        "aten.to.device": _to,
        "aten.to.dtype": _to,
        "aten.transpose.int": _transpose,
        "aten.unbind.int": lambda x, dim=0: tf.unstack(
            x, axis=_dim(dim, len(x.shape))),
        "aten.unsqueeze.default": _unsqueeze,
        "aten.var_mean.correction": _var_mean,
        "aten.view.default": tf.reshape,
        "aten.where.self": _where,
        "aten.zeros_like.default": _like(tf.zeros_like),
    })
    return table


def op_name(target) -> str:
    """The table's key of a call_function node's target."""
    if target is operator.getitem:
        return "getitem"
    return str(target)


def missing_ops(program) -> set:
    """The op names of `program`'s graph outside the table."""
    known = set(_table()) | {"getitem"}
    return {op_name(n.target) for n in program.graph.nodes
            if n.op == "call_function"} - known


def _run(program, table, variables, inputs):
    """Replay `program`'s graph on TF values: `variables` by the lifted
    tensors' placeholder names, `inputs` in user-input order."""
    env = {}
    user = iter(inputs)
    for node in program.graph.nodes:
        if node.op == "placeholder":
            env[node.name] = variables[node.name] if node.name in variables \
                else next(user)
        elif node.op == "call_function":
            args = torch.fx.node.map_arg(node.args, lambda n: env[n.name])
            kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n.name])
            name = op_name(node.target)
            if name == "getitem":
                env[node.name] = args[0][args[1]]
                continue
            kwargs = {k: v for k, v in kwargs.items()
                      if k not in ("device", "layout", "pin_memory",
                                   "memory_format", "non_blocking", "copy")}
            env[node.name] = table[name](*args, **kwargs)
        elif node.op == "output":
            outs = torch.fx.node.map_arg(node.args[0], lambda n: env[n.name])
            return outs[0] if isinstance(outs, (list, tuple)) else outs
        else:
            raise NotImplementedError(f"graph node kind {node.op}")
    raise ValueError("the program's graph has no output node")


def lower(program, input_signature):
    """A `tf.Module` that replays `program` (a `torch.export`
    ExportedProgram whose weights are lifted tensors): its lifted tensors
    as `tf.Variable`s (`module.weights`) and `module.predict`, a
    `tf.function` of `input_signature` (TensorSpecs of the user inputs in
    order; integer inputs are cast to the graph's dtype).  Raises
    NotImplementedError, naming the ops, where the graph holds an op
    outside the table."""
    tf = _tf()
    missing = missing_ops(program)
    if missing:
        raise NotImplementedError(
            f"ATen ops without a TensorFlow lowering: {sorted(missing)}")
    values = {**program.state_dict, **program.constants}
    lifted, dtypes = {}, []
    for spec in program.graph_signature.input_specs:
        if spec.kind.name == "USER_INPUT":
            continue
        lifted[spec.arg.name] = values[spec.target]
    for node in program.graph.nodes:
        if node.op == "placeholder" and node.name not in lifted:
            dtypes.append(node.meta["val"].dtype)
    table = _table()
    module = tf.Module()
    module.weights = {name: tf.Variable(t.detach().cpu().numpy(),
                                        trainable=False, name=name)
                      for name, t in lifted.items()}

    @tf.function(input_signature=input_signature, autograph=False)
    def predict(*inputs):
        cast = [tf.cast(x, tf_dtype(dt)) for x, dt in zip(inputs, dtypes)]
        return _run(program, table, module.weights, cast)

    module.predict = predict
    return module
