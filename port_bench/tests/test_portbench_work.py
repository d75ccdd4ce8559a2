"""The operation and byte counts of `work/` against hand-worked shapes."""
import pytest

from port_bench.work import block12, conv, gram, model, peaks

BLOCKS = [[2, 64], [2, 128], [4, 256], [4, 512], [4, 512]]


def test_conv_work_by_hand():
    # 2·9·3·64 operations a pixel over 4×4 pixels; bf16 input, output
    # and weights read or written once: ((3 + 64)·16 + 9·3·64)·2 bytes
    assert conv.conv_work(3, 64, 4, 4, 2) == (5600, 55296.0)


def test_layer_shapes_strides():
    shapes = conv.layer_shapes(BLOCKS, 64, 32, "conv4_2")
    assert [s[0] for s in shapes] == [
        "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
        "conv3_3", "conv3_4", "conv4_1", "conv4_2"]
    assert shapes[0] == ("conv1_1", 3, 64, 64, 32)
    assert shapes[2] == ("conv2_1", 64, 128, 32, 16)
    assert shapes[-1] == ("conv4_2", 512, 512, 8, 4)
    tail = conv.step_convs(BLOCKS, 64, 32, "conv5_1", "conv3_1")
    assert tail[0] == (128, 256, 16, 8) and len(tail) == 9


def test_gram_work_by_hand():
    # C = 2, P = 10, K = 3, bf16: the forward reads F and the masks and
    # writes three 2×2 fp32 Grams; the backward reads F, the masks and the
    # cotangents and writes dF; 2·K·C²·P operations each
    assert gram.gram_fwd_work(2, 10, 3, 2) == ((20 + 30) * 2 + 48, 240.0)
    assert gram.gram_bwd_work(2, 10, 3, 2) == ((40 + 30 + 12) * 2, 240.0)


def test_block12_work_by_hand():
    h = w = 8
    k, isz = 2, 2
    p, p2 = 64, 16
    conv_ops = lambda cin, cout, n: 2 * 9 * cin * cout * n
    fwd_ops = (conv_ops(3, 64, p) + conv_ops(64, 64, p)
               + conv_ops(64, 128, p2) + conv_ops(128, 128, p2)
               + 2 * k * (64 * 64 * p + 128 * 128 * p2))
    work = block12.b12_work(h, w, k, isz)
    assert work["block12_fwd"][1] == fwd_ops
    assert work["block12_fwd"][0] == (3 * p * 4 + k * (p + p2) * 4
                                      + k * (64 * 64 + 128 * 128) * 4
                                      + 128 * 4 * isz)
    assert work["block12_fwd_res"][0] - work["block12_fwd"][0] == (
        64 * p + 2 * 128 * p2) * isz
    assert work["block12_bwd_deep"][1] == (conv_ops(128, 128, p2)
                                           + conv_ops(64, 128, p2)
                                           + 2 * k * 128 * 128 * p2)
    assert work["block12_bwd_shallow"][1] == (2 * conv_ops(64, 64, p)
                                              + conv_ops(3, 64, p)
                                              + 2 * k * 64 * 64 * p)


def test_model_ops_at_512():
    """About 450 GFLOP a pair-step at 512², K = 4: 189.3 in VGG's forward
    to conv5_1, as much in its input gradient, 73 in the Grams and their
    cotangents."""
    layers = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
    fwd = sum(conv.conv_work(*s[1:], 2)[1]
              for s in conv.layer_shapes(BLOCKS, 512, 512, "conv5_1"))
    assert fwd == pytest.approx(189.3e9, rel=1e-3)
    ops = model.step_ops(BLOCKS, 512, 512, 4, layers, "conv5_1")
    assert ops == pytest.approx(2 * fwd + 4 * 4 * (
        64 ** 2 * 2 ** 18 + 128 ** 2 * 2 ** 16 + 256 ** 2 * 2 ** 14
        + 512 ** 2 * 2 ** 12 + 512 ** 2 * 2 ** 10))
    assert ops == pytest.approx(451.6e9, rel=1e-3)


def test_bound_is_the_larger():
    assert peaks.bound_s(3.35e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12, "float32") == pytest.approx(1.0)
