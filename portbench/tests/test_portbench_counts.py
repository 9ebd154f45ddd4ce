"""The yardstick reproduces the kernel table's bounds (H100 SXM5 data
sheet: 989 TFLOP/s bf16, 3.35 TB/s) and the model FLOPs of a step."""
import pytest

from portbench import counts

H100 = counts.peaks_for("NVIDIA H100 80GB HBM3")


def ms(nbytes, nops):
    return counts.bound_s(nbytes, nops, H100) * 1e3


def test_peaks_by_name():
    assert H100 == dict(bytes=3.35e12, bf16=989e12, fp32=67e12)
    assert counts.peaks_for("NVIDIA H100 PCIe")["bytes"] == 2.0e12
    with pytest.raises(KeyError):
        counts.peaks_for("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("lse", [False, True])
def test_k2_forward_bound(lse):
    # (1, 4096, 32/4, 128) causal: operations bound it, 0.1390 ms
    got = ms(counts.k2_forward_bytes(1, 4096, 32, 4, 128, lse),
             counts.k2_forward_ops(1, 4096, 32, 128, causal=True))
    assert round(got, 4) == 0.1390


def test_k2_backward_bound():
    got = ms(counts.k2_backward_bytes(1, 4096, 32, 4, 128),
             counts.k2_backward_ops(1, 4096, 32, 128, causal=True))
    assert round(got, 4) == 0.3475
    assert counts.k2_backward_ops(1, 4096, 32, 128) \
        == 2.5 * counts.k2_forward_ops(1, 4096, 32, 128)


def test_k1_bounds():
    assert round(ms(counts.k1_forward_bytes(4096, 4096), 0), 5) == 0.02003
    assert round(ms(counts.k1_backward_bytes(4096, 4096), 0), 5) == 0.03005


@pytest.mark.parametrize("S,window,want", [
    (4096, 0, 4096 * 4097 // 2),
    (4096, 4096, 4096 * 4097 // 2),        # a window that never bites
    (4096, 1024, 1024 * 1025 // 2 + 3072 * 1024),
    (10, 3, sum(min(q + 1, 3) for q in range(10))),
])
def test_attention_pairs(S, window, want):
    assert counts.attention_pairs(S, S, True, window) == want


def test_attention_pairs_not_causal():
    assert counts.attention_pairs(1500, 1500, False) == 1500 * 1500


def _config(name):
    from portbench import bench
    return bench.load_json(bench.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,layers,want", [("yi-9b-16L", 12, 6.24e13),
                                              ("mixtral-8x7b-2L", 2, 2.34e13)])
def test_train_step_flops(name, layers, want):
    """A 1 x 4096 step's model FLOPs, at the depths that run CO measured."""
    c = dict(_config(name), num_hidden_layers=layers)
    got = counts.step_flops(c, [4096], True, c.get("sliding_window") or 0)
    assert got == pytest.approx(want, rel=5e-3)


def test_prefill_is_a_third_of_a_train_step():
    c = _config("yi-9b-16L")
    assert 3 * counts.step_flops(c, [2048], False) \
        == counts.step_flops(c, [2048], True)


def test_product_params_leave_out_the_embedding_and_inactive_experts():
    y, m = _config("yi-9b"), _config("mixtral-8x7b-2L")
    layer = 4096 * 4096 * 2 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert counts.product_params(y) == 48 * layer + 4096 * 64000
    moe = 4096 * 4096 * 2 + 2 * 4096 * 1024 + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert counts.product_params(m) == 2 * moe + 4096 * 32000
