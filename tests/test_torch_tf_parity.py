"""The port's TF1 idioms against real TensorFlow ops (tf.compat.v1), the
counterpart of tests/test_tf_parity.py, with its cases and tolerances:
TF1 `resize_bilinear` (no half-pixel centres), the weighed logistic loss,
the LSTM against TF's block LSTM kernel with a TF-layout kernel (the
converter copies 'rnn/lstm_cell/kernel' unchanged, so this holds its gate
order i, j, f, o against TF itself), the reverse scan of
`bidirectional_dynamic_rnn`, `rgb_to_hsv` and `l2_normalize`.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from cmpc_refseg_torch.models.language import lstm_scan  # noqa: E402
from cmpc_refseg_torch.models.model import rgb_to_hsv  # noqa: E402
from cmpc_refseg_torch.ops.losses import weighed_logistic_loss  # noqa: E402
from cmpc_refseg_torch.ops.normalization import l2_normalize  # noqa: E402
from cmpc_refseg_torch.ops.resize import resize_bilinear  # noqa: E402


def _t(x):
    return torch.as_tensor(x)


class TestResizeParity:
    def test_resize_bilinear_random_shapes(self, rng):
        """20 random shape pairs: the grid mapping, exhaustively."""
        for _ in range(20):
            ih, iw = int(rng.integers(2, 90)), int(rng.integers(2, 90))
            oh, ow = int(rng.integers(2, 90)), int(rng.integers(2, 90))
            x = rng.standard_normal((1, ih, iw, 2)).astype(np.float32)
            want = tf.compat.v1.image.resize_bilinear(
                tf.constant(x), (oh, ow), align_corners=False).numpy()
            got = resize_bilinear(_t(x), oh, ow).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5,
                                       err_msg=f"{(ih, iw)}->{(oh, ow)}")

    @pytest.mark.parametrize("in_hw,out_hw", [
        ((40, 40), (320, 320)), ((13, 17), (64, 48)), ((64, 48), (13, 17)),
        ((8, 8), (8, 8)),
    ])
    def test_resize_bilinear_matches_tf1(self, rng, in_hw, out_hw):
        x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
        want = tf.compat.v1.image.resize_bilinear(
            tf.constant(x), out_hw, align_corners=False).numpy()
        got = resize_bilinear(_t(x), *out_hw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestLossParity:
    def test_weighed_logistic_loss_matches_tf(self, rng):
        """util/loss.py:6-16: sigmoid CE with positive / negative weights,
        summed over H, W, C, averaged over the batch."""
        scores = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
        labels = (rng.random((2, 5, 5, 1)) > 0.5).astype(np.float32)
        pos_mult, neg_mult = 1.5, 0.5
        ce = tf.nn.sigmoid_cross_entropy_with_logits(
            labels=tf.constant(labels), logits=tf.constant(scores))
        w = labels * pos_mult + (1 - labels) * neg_mult
        want = tf.reduce_mean(tf.reduce_sum(ce * w, axis=[1, 2, 3])).numpy()
        got = float(weighed_logistic_loss(_t(scores), _t(labels), pos_mult,
                                          neg_mult))
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestLSTMParity:
    """Golden: tf.raw_ops.BlockLSTM, TF's fused LSTM kernel, with TF1
    LSTMCell's ICFO weight layout and forget_bias semantics."""

    def _tf_block_lstm(self, x, kernel, bias, hidden):
        b, t, _ = x.shape
        out = tf.raw_ops.BlockLSTM(
            seq_len_max=tf.constant(t, tf.int64),
            x=tf.constant(np.swapaxes(x, 0, 1)),          # [T, B, D]
            cs_prev=tf.zeros((b, hidden)), h_prev=tf.zeros((b, hidden)),
            w=tf.constant(kernel), wci=tf.zeros((hidden,)),
            wcf=tf.zeros((hidden,)), wco=tf.zeros((hidden,)),
            b=tf.constant(bias), use_peephole=False, forget_bias=1.0,
            cell_clip=-1.0)
        return np.swapaxes(out.h.numpy(), 0, 1)           # [B, T, H]

    def test_lstm_scan_matches_tf_block_lstm(self, rng):
        b, t, d, h = 2, 7, 5, 6
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        kernel = (0.3 * rng.standard_normal((d + h, 4 * h))).astype(
            np.float32)
        bias = (0.1 * rng.standard_normal((4 * h,))).astype(np.float32)
        want_h = self._tf_block_lstm(x, kernel, bias, h)

        seq_len = np.asarray([4, 7], np.int64)
        got_out, got_final = lstm_scan(
            {"kernel": _t(kernel), "bias": _t(bias)}, _t(x), _t(seq_len))
        got_out = got_out.numpy()
        # the valid positions match the TF kernel
        np.testing.assert_allclose(got_out[0, :4], want_h[0, :4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_out[1], want_h[1],
                                   rtol=1e-5, atol=1e-5)
        # dynamic_rnn: zero outputs and a frozen state past seq_len
        assert np.all(got_out[0, 4:] == 0)
        np.testing.assert_allclose(got_final.numpy()[0], want_h[0, 3],
                                   rtol=1e-5, atol=1e-5)

    def test_reverse_scan_matches_tf_reverse_sequence(self, rng):
        """reverse=True == tf.reverse_sequence -> forward LSTM ->
        re-reverse (bidirectional_dynamic_rnn's backward pass)."""
        b, t, d, h = 2, 6, 4, 5
        x = rng.standard_normal((b, t, d)).astype(np.float32)
        seq_len = np.asarray([3, 6], np.int64)
        kernel = (0.3 * rng.standard_normal((d + h, 4 * h))).astype(
            np.float32)
        bias = np.zeros((4 * h,), np.float32)

        x_rev = tf.reverse_sequence(tf.constant(x), tf.constant(seq_len),
                                    seq_axis=1, batch_axis=0).numpy()
        want_fwd = self._tf_block_lstm(x_rev, kernel, bias, h)
        for i, s in enumerate(seq_len):       # dynamic_rnn zeros past it
            want_fwd[i, s:] = 0
        want = tf.reverse_sequence(tf.constant(want_fwd),
                                   tf.constant(seq_len),
                                   seq_axis=1, batch_axis=0).numpy()
        got, _ = lstm_scan({"kernel": _t(kernel), "bias": _t(bias)}, _t(x),
                           _t(seq_len), reverse=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class TestMiscParity:
    def test_rgb_to_hsv_matches_tf(self, rng):
        x = rng.random((4, 4, 3)).astype(np.float32) * 255.0
        want = tf.image.rgb_to_hsv(tf.constant(x / 255.0)).numpy()
        got = rgb_to_hsv(_t(x / 255.0)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_l2_normalize_matches_tf(self, rng):
        x = rng.standard_normal((3, 7)).astype(np.float32)
        want = tf.math.l2_normalize(tf.constant(x), axis=-1).numpy()
        got = l2_normalize(_t(x), -1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
