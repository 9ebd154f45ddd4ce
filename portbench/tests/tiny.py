"""Tiny sizes of the benchmark's configurations and mixes, for the CPU
tests: every width cut, the structure (GQA, experts top-2, the window)
kept."""
import time

from portbench import bench

DENSE = {
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "vocab_size": 256,
}
PORT_DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=96, vocab=256, dtype="float32")
MIXES = {
    "train-4k": {"seq": 48, "microbatches": 2},
    "prefill-mix": {"lengths": {"dist": "log_uniform", "min": 12, "max": 48,
                                "count": 6}, "trace_requests": 3},
}


def config_override(cell: dict, dtype: str = "float32") -> dict:
    full = bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    over = dict(DENSE)
    fields = dict(PORT_DENSE, dtype=dtype, **full["port"]["fields"])
    fields.update(PORT_DENSE, dtype=dtype)
    if full.get("num_local_experts"):
        over["intermediate_size"] = 80
        fields.update(moe_d_ff=80)
    if full.get("sliding_window"):
        over["sliding_window"] = 32
        fields.update(window=32)
    over["port"] = {"arch": full["port"]["arch"], "fields": fields}
    return over


def tiny_run(name: str, seed: int = 12345, seconds: float = 0.5,
             trace: bool = False, entry=None, dtype: str = "float32"):
    spec = bench.load_bench()
    cell = bench.find_cell(spec, name)
    return bench.Run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                     config_override=config_override(cell, dtype),
                     mix_override=MIXES[cell["traffic"]], entry=entry,
                     bench=spec)
