"""The yardstick's counts against counts worked out by hand."""

import pytest
import torch

from benchmark import roofline


def test_resblock_counts_by_hand():
    # B 1, C 2, T 4, k 3: two convs of 2 * 1 * 4 * 2 * 2 * 3 = 96 flops
    # each, 5 elementwise ops on 8 elements; x and out 8 floats each,
    # weights 2 * 3 * 2 * 2 = 24, biases 4: 44 floats
    assert roofline.resblock_flops(1, 2, 4, 3) == 2 * 96 + 40
    assert roofline.resblock_bytes(1, 2, 4, 3) == 4 * 44
    # B 2, C 4, T 10, k 7 in bf16: two convs of 2 * 2 * 10 * 4 * 4 * 7 =
    # 4480 flops, 5 * 80 elementwise; 80 + 80 + 2 * 7 * 16 + 8 = 392
    # values of 2 bytes
    assert roofline.resblock_flops(2, 4, 10, 7) == 2 * 4480 + 400
    assert roofline.resblock_bytes(2, 4, 10, 7, "bfloat16") == 2 * 392


def test_bound_names_what_binds():
    _, small = roofline.launch_bound_s(1, 2, 4, 3)
    _, big = roofline.launch_bound_s(8, 256, 10_000, 11)
    assert small == "bytes" and big == "operations"


def test_launch_shapes_of_a_decode():
    model = {"upsample_rates": [12, 10, 2, 2], "upsample_initial_channel": 512,
             "resblock_kernel_sizes": [3, 7, 11],
             "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    shapes = roofline.resblock_launch_shapes(model, 8, 998)
    assert len(shapes) == 36
    assert shapes[0] == (8, 256, 998 * 12, 3, 1) and shapes[-1] == (8, 32, 998 * 480, 11, 5)


def test_roofline_share_silent_when_launches_differ():
    shapes = [(1, 256, 1000, 3, 1)] * 2
    assert roofline.roofline_share(shapes, [1.0]) is None
    share, by = roofline.roofline_share(shapes, [1.0, 1.0])
    assert by == {"operations": 2} and 0 < share < 100


@pytest.mark.parametrize("b,t,n,d", [(1, 5, 7, 3), (2, 11, 13, 4)])
def test_model_counts_by_hand(b, t, n, d):
    # the blend's distance product: 2 * B * T * D * N
    from benchmark.reference.convert import retrieval_blend

    feats, vecs = torch.empty((b, t, d), device="meta"), torch.empty((n, d), device="meta")
    assert roofline._count(lambda: retrieval_blend(feats, vecs, 0.5, k=3)) == 2 * b * t * d * n


def test_meta_gru_matches_the_counted_gru():
    gru = torch.nn.GRU(6, 4, batch_first=True, bidirectional=True)
    x = torch.randn(2, 9, 6)
    meta = roofline._MetaGRU(6, 4)
    meta(x)
    # by hand: 2 directions x 9 steps x 2 rows x 2 x 3 gates x 4 x (6 + 4)
    assert meta.flops == 2 * 9 * 2 * 2 * 3 * 4 * 10
    assert roofline._count(lambda: gru(x)) == meta.flops
