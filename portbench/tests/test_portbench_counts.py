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


# ---------------------------------------------------------------------------
# The structure a configuration states: latent attention, shared experts,
# leading dense layers, a chip's share of the experts
# ---------------------------------------------------------------------------

PAIRS_4096 = 4096 * 4097 // 2

# the yardstick's counts for the four cells' configurations before it read
# latent attention and shared experts: product parameters a token, a train
# step of 8 x 4096, the prefill mix's 64 lengths, and per launch K2's
# forward (the mix's lengths summed; 4096 with the LSE), K2's backward at
# 4096 and K1's at 4096 rows, as (operations, bytes) or bytes
PARENT = {
    "yi-9b-16L": dict(
        pp=3030384640, train=648587306336256, prefill=907160379981824,
        k2f_ops=2975243649024, k2f_bytes=2614081536,
        k2ft=[137472507904, 76021760], k2b=[343681269760, 151519232]),
    "mixtral-8x7b-2L": dict(
        pp=919666688, train=187412508573696, prefill=266810264682496,
        k2f_ops=2975243649024, k2f_bytes=2904535040,
        k2ft=[137472507904, 84410368], k2b=[343681269760, 168296448]),
    "yi-9b": dict(
        pp=8566865920, train=1842682703904768, prefill=2572768945897472,
        k2f_ops=2975243649024, k2f_bytes=2614081536,
        k2ft=[137472507904, 76021760], k2b=[343681269760, 151519232]),
    "mixtral-8x7b-20L": dict(
        pp=8017018880, train=1642196851752960, prefill=2333500210216960,
        k2f_ops=2975243649024, k2f_bytes=2904535040,
        k2ft=[137472507904, 84410368], k2b=[343681269760, 168296448]),
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_cells_count_as_before(name):
    from portbench import mixes
    c, want = _config(name), PARENT[name]
    lens = mixes.lengths(mixes.load("prefill-mix")["lengths"])
    w = c.get("sliding_window") or 0
    H, KV, d_qk, d_v = counts.attention_dims(c)
    assert d_qk == d_v
    assert counts.product_params(c) == want["pp"]
    assert counts.step_flops(c, [4096] * 8, True, w) == want["train"]
    assert sum(counts.step_flops(c, [S], False, w) for S in lens) \
        == want["prefill"]
    assert sum(counts.k2_forward_ops(1, S, H, d_qk, True, w, d_v=d_v)
               for S in lens) == want["k2f_ops"]
    assert sum(counts.k2_forward_bytes(1, S, H, KV, d_qk, False, d_v=d_v)
               for S in lens) == want["k2f_bytes"]
    assert [counts.k2_forward_ops(1, 4096, H, d_qk, True, w, d_v=d_v),
            counts.k2_forward_bytes(1, 4096, H, KV, d_qk, True, d_v=d_v)] \
        == want["k2ft"]
    assert [counts.k2_backward_ops(1, 4096, H, d_qk, True, w, d_v=d_v),
            counts.k2_backward_bytes(1, 4096, H, KV, d_qk, d_v=d_v)] \
        == want["k2b"]
    assert counts.k1_norms(c) == [(2 * c["num_hidden_layers"] + 1, 4096)]
    assert [counts.k1_forward_bytes(4096, 4096),
            counts.k1_backward_bytes(4096, 4096)] == [67117056, 100679680]


# the roofline readers over a synthetic stretch (kernel names and times
# made up, launches as each cell's inputs need), as they read before
PARENT_ROOFLINES = {
    "yi9b-train-4k": (61.79960260388373, 34.70699742207983,
                      34.40631798896775),
    "mixtral-train-4k": (61.79960260388373, 34.70699742207983,
                         34.40631798896775),
    "yi9b-prefill-mix": (33.068938011753424, 9.961606787926172, None),
    "mixtral-prefill-mix": (33.068938011753424, 9.96160678792617, None),
}


def synthetic_run(cell):
    from types import SimpleNamespace
    from portbench import bench, mixes
    spec = bench.find_cell(bench.load_bench(), cell)
    c, mix = _config(spec["config"]), mixes.load(spec["traffic"])
    L, train = c["num_hidden_layers"], mix["driver"] == "train"
    m = mix.get("microbatches", 1)
    seqs_list = [[mix["seq"]] * m * mix["batch"]] * 2 if train \
        else [[S] for S in mixes.lengths(mix["lengths"])[::8]]
    calls = []
    for j, seqs in enumerate(seqs_list):
        k = [("rmsnorm_ring", 3e-5 + 1e-7 * j)] * ((2 * L + 1) * m)
        k += [("flash_fwd_sm90_kernel", 4e-4 + 1e-6 * j)] * (L * m)
        if train:
            k += [("rmsnorm_bwd", 5e-5)] * ((2 * L + 1) * m)
            k += [("rmsnorm_bwd_colsum", 1e-6)] * ((2 * L + 1) * m)
            k += [("flash_bwd_sm90", 1e-3), ("bwd_prologue", 1e-5)] * (L * m)
        calls.append({"seqs": seqs, "kernels": k})
    return SimpleNamespace(config=c, mix=mix, stretch={"calls": calls},
                           peaks=H100)


@pytest.mark.parametrize("cell", sorted(PARENT_ROOFLINES))
def test_roofline_readers_read_as_before(cell):
    from portbench import bench
    run = synthetic_run(cell)
    got = tuple(bench.metric_reader(m).read(run) for m in
                ("k1_roofline", "k2_fwd_roofline", "k2_bwd_roofline"))
    assert got == PARENT_ROOFLINES[cell]


# Kimi-K2-Instruct's published config.json (huggingface.co/moonshotai/
# Kimi-K2-Instruct), the keys the yardstick reads
KIMI_K2 = dict(hidden_size=7168, intermediate_size=18432,
               moe_intermediate_size=2048, num_hidden_layers=61,
               num_attention_heads=64, num_key_value_heads=64,
               q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
               qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=384,
               n_shared_experts=1, num_experts_per_tok=8,
               first_k_dense_replace=1, vocab_size=163840)
# DeepSeek-V2-Lite's (huggingface.co/deepseek-ai/DeepSeek-V2-Lite): no q
# compression, two shared experts
DEEPSEEK_V2_LITE = dict(hidden_size=2048, intermediate_size=10944,
                        moe_intermediate_size=1408, num_hidden_layers=27,
                        num_attention_heads=16, num_key_value_heads=16,
                        q_lora_rank=None, kv_lora_rank=512,
                        qk_nope_head_dim=128, qk_rope_head_dim=64,
                        v_head_dim=128, n_routed_experts=64,
                        n_shared_experts=2, num_experts_per_tok=6,
                        first_k_dense_replace=1, vocab_size=102400)


def test_kimi_k2_whole():
    d, H = 7168, 64
    q = d * 1536 + 1536 * H * (128 + 64)            # 29,884,416
    kv_a = d * (512 + 64)                           # 4,128,768
    kv_b = 512 * H * (128 + 128)                    # 8,388,608
    o = H * 128 * d                                 # 58,720,256
    attn = q + kv_a + kv_b + o                      # 101,122,048
    dense = 3 * d * 18432                           # 396,361,728
    moe = d * 384 + 1 * 3 * d * 2048 + 8 * 3 * d * 2048   # 399,114,240
    unembed = d * 163840                            # 1,174,405,120
    want = 61 * attn + dense + 60 * moe + unembed
    assert want == 31_686_066_176
    assert counts.product_params(KIMI_K2) == want
    core = 61 * 2 * H * (192 + 128) * PAIRS_4096    # 20,964,557,455,360
    assert 2 * want * 4096 + core == 280_536_811_569_152
    assert counts.forward_flops(KIMI_K2, [4096]) == 280_536_811_569_152


def test_kimi_k2_eight_of_384_experts_held():
    """A 48-way expert-parallel layer's share: the router keeps its 384
    outputs, a token's 8 experts lie here 8/384 of the time."""
    c = dict(KIMI_K2, n_routed_experts=8, published={"n_routed_experts": 384},
             reduced=["n_routed_experts"])
    assert counts.expert_counts(c) == (8, 384)
    d = 7168
    attn = 101_122_048
    moe = d * 384 + 3 * d * 2048 + 8 * 8 * 3 * d * 2048 // 384
    assert moe == 2_752_512 + 44_040_192 + 7_340_032
    want = 61 * attn + 3 * d * 18432 + 60 * moe + d * 163840
    assert want == 10_987_175_936
    assert counts.product_params(c) == want
    core = 61 * 2 * 64 * (192 + 128) * PAIRS_4096
    assert 2 * want * 4096 + core == 110_971_502_723_072
    assert counts.forward_flops(c, [4096]) == 110_971_502_723_072


def test_deepseek_v2_lite():
    d, H = 2048, 16
    q = d * H * (128 + 64)                          # no q_lora_rank
    kv_a = d * (512 + 64)
    kv_b = 512 * H * (128 + 128)
    o = H * 128 * d
    attn = q + kv_a + kv_b + o                      # 13,762,560
    dense = 3 * d * 10944
    moe = d * 64 + 2 * 3 * d * 1408 + 6 * 3 * d * 1408
    want = 27 * attn + dense + 26 * moe + d * 102400
    assert want == 2_451_308_544
    assert counts.product_params(DEEPSEEK_V2_LITE) == want
    core = 27 * 2 * H * (192 + 128) * PAIRS_4096
    assert 2 * want * 4096 + core == 22_400_968_163_328
    assert counts.forward_flops(DEEPSEEK_V2_LITE, [4096]) \
        == 22_400_968_163_328


def test_k2_at_qk_192_v_128():
    """MLA's prefill form: H = KV = 64; q and k read at 192, v read and o
    written at 128."""
    assert counts.attention_dims(KIMI_K2) == (64, 64, 192, 128)
    ops = 2 * 64 * (192 + 128) * PAIRS_4096
    assert ops == 343_681_269_760
    assert counts.k2_forward_ops(1, 4096, 64, 192, d_v=128) == ops
    nbytes = (4096 * 64 * 192 * 2 + 4096 * 64 * 128 * 2) * 2
    assert nbytes == 335_544_320
    assert counts.k2_forward_bytes(1, 4096, 64, 64, 192, False,
                                   d_v=128) == nbytes
    # the backward's five products: S, dK, dQ at 192; dP, dV at 128
    assert counts.k2_backward_ops(1, 4096, 64, 192, d_v=128) \
        == 2 * 64 * (3 * 192 + 2 * 128) * PAIRS_4096
    assert counts.k2_backward_bytes(1, 4096, 64, 64, 192, d_v=128) \
        == (2 * 4096 * 64 * 320 * 2) * 2 + 64 * 4096 * 4


def test_k1_norms_of_mla():
    assert counts.k1_norms(KIMI_K2) == [(123, 7168), (61, 1536), (61, 512)]
    assert counts.k1_norms(DEEPSEEK_V2_LITE) == [(55, 2048), (27, 512)]


def test_k1_roofline_sums_the_widths():
    """An MLA training step's K1 launches at three widths read as one
    roofline: the bounds summed over the widths."""
    from types import SimpleNamespace
    c = dict(KIMI_K2, num_hidden_layers=2)
    norms = counts.k1_norms(c)
    m = 8
    n = sum(k for k, _ in norms) * m
    call = {"seqs": [4096] * m, "kernels": [("rmsnorm_ring", 1e-5)] * n
            + [("rmsnorm_bwd", 2e-5)] * n}
    run = SimpleNamespace(config=c, mix={"driver": "train", "microbatches": m},
                          stretch={"calls": [call]}, peaks=H100)
    from portbench import bench
    got = bench.metric_reader("k1_roofline").read(run)
    bound = sum(k * m * (counts.k1_forward_bytes(4096, D)
                         + counts.k1_backward_bytes(4096, D))
                for k, D in norms) / H100["bytes"]
    assert got == pytest.approx(100 * bound / (n * 3e-5), rel=1e-12)
