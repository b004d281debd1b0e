"""The port's benchmark harness (``flashattention_tpu_torch/bench``) on the
CPU: the FLOP model against the JAX package's, the record schema shared
with it, results files, tables and figures (matplotlib's Agg backend), the
card peaks, a sweep cell's subprocess and its failure record, and one
2-rank gloo run of the scaling harness. Timing needs the card
(``tests/test_torch_cuda.py``).
"""

import argparse
import dataclasses
import json

import pytest
import torch

from flashattention_tpu.bench import harness as jharness
from flashattention_tpu_torch.bench import harness, plotting, scaling, sweep
from flashattention_tpu_torch.bench.harness import BenchRecord


@pytest.mark.parametrize("direction", ["forward", "backward", "both"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_flops_equal_jax(direction, causal):
    for shape in ((1, 8, 8192, 128), (2, 12, 512, 64), (3, 5, 1000, 256)):
        assert harness.attention_flops(*shape, direction=direction,
                                       causal=causal) == \
            jharness.attention_flops(*shape, direction=direction,
                                     causal=causal)


def _records():
    recs = []
    for i, (algo, direction, n, causal) in enumerate([
            ("fa2", "forward", 1024, False), ("fa2", "forward", 4096, True),
            ("fa2", "backward", 1024, True), ("fa3", "forward", 4096, True)]):
        recs.append(BenchRecord(
            algo=algo, backend="kernel", direction=direction, batch=1,
            heads=4, seqlen=n, head_dim=128, causal=causal, dtype="bf16",
            mean_ms=0.1 * (i + 1), pstdev_ms=0.01, tflops=100.0 + i,
            roofline_frac=0.1 + 0.01 * i, peak_mem_mb=12.5,
            mem_source="cuda_max_allocated"))
    recs.append(BenchRecord(
        algo="fa2", backend="kernel", direction="forward", batch=1, heads=4,
        seqlen=16384, head_dim=256, causal=True, dtype="bf16", status="oom",
        error="OutOfMemoryError"))
    return recs


def test_record_schema_is_jax_s():
    names = [f.name for f in dataclasses.fields(BenchRecord)]
    assert names == [f.name for f in dataclasses.fields(jharness.BenchRecord)]
    rec = _records()[0]
    assert jharness.BenchRecord(**rec.row()).row() == rec.row()
    jrec = jharness.BenchRecord(algo="fa2", backend="pallas",
                                direction="forward", batch=1, heads=4,
                                seqlen=512, head_dim=64, causal=True,
                                dtype="bf16")
    assert BenchRecord(**jrec.row()).row() == jrec.row()


def test_write_results_and_console_table(tmp_path):
    recs = _records()
    jpath, cpath = harness.write_results(recs, tmp_path, "t")
    rows = json.loads(jpath.read_text())
    assert [BenchRecord(**r) for r in rows] == recs
    assert cpath.read_text().splitlines()[0].split(",")[0] == "algo"
    assert len(cpath.read_text().splitlines()) == len(recs) + 1
    table = harness.console_table(recs)
    assert table.splitlines()[1].startswith("---")
    assert harness.console_table(recs) == jharness.console_table(
        [jharness.BenchRecord(**r.row()) for r in recs])
    with pytest.raises(ValueError, match="at least one"):
        harness.write_results([], tmp_path, "t")


def test_plots_and_tables(tmp_path):
    recs = _records()
    card = "NVIDIA H100 80GB HBM3"
    for path in (plotting.plot_sweep(recs, tmp_path, "t", card),
                 plotting.plot_mixed_figure(recs, tmp_path, "t", card)):
        assert path.suffix == ".png" and path.stat().st_size > 1000
    paths = plotting.render_ablation_table(recs, tmp_path, "t")
    assert set(paths) == {"md", "tex", "png"}
    md = paths["md"].read_text().splitlines()
    assert len(md) == 2 + len(recs) and "oom" in md[-1]
    assert "\\toprule" in paths["tex"].read_text()
    assert "\\%" in plotting.ablation_table_tex(recs)


def test_peak_tflops_from_the_card_name():
    h100 = "NVIDIA H100 80GB HBM3"
    assert harness.peak_tflops("bf16", h100) == 989.0
    assert harness.peak_tflops("fp32", h100) == 165.0  # 3xTF32: 495 / 3
    for fmt in ("fp8", "e5m2", "int8"):
        assert harness.peak_tflops(fmt, h100) == 1979.0
    with pytest.raises(ValueError, match="no peak rates known"):
        harness.peak_tflops("bf16", "TPU v5 lite")
    with pytest.raises(ValueError, match="no peak rate for dtype"):
        harness.peak_tflops("fp16", h100)


def test_sweep_cell_without_a_card_records_a_failure():
    """No card here: the cell's subprocess runs and reports a failed
    record, and the sweep itself refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ns = argparse.Namespace(batch=1, heads=4, fp8=False, fp8_fmt="fp8",
                            dropout=0.0, kv_heads=None, cell_timeout=120.0)
    rec = sweep._subprocess_cell(ns, "fa2", "kernel", "backward", "bf16",
                                 256, 64, True)
    assert (rec.status, rec.direction, rec.seqlen, rec.causal) == \
        ("failed", "backward", 256, True)
    assert rec.error
    assert sweep.run_config(sweep.cell("fa3", "forward", 256, 64, fp8=True,
                                       fp8_fmt="int8")).status == "failed"
    with pytest.raises(SystemExit, match="no CUDA device|none"):
        sweep.main(["--quick"])


def test_scaling_two_gloo_ranks():
    """One 2-rank gloo world (and the 1-rank world it is compared with)
    through the sharded step: finite tokens/s, labelled as program
    validation."""
    cfg = scaling.bench_config(seq_len=32, vocab_size=97, d_model=32,
                               n_layers=2, n_heads=4, d_ff=64,
                               dtype=torch.float32)
    recs = scaling.scaling_records([1, 2], "gloo", cfg=cfg, batch_per_device=2,
                                   seq_len=32, steps=2, timeout=300.0)
    assert [r["devices"] for r in recs] == [1, 2]
    for r in recs:
        assert r["mode"].startswith("program-validation")
        assert r["value"] > 0 and "efficiency_vs_linear" not in r
    assert recs[0]["host_contention_ratio"] == 1.0
    assert recs[1]["host_contention_ratio"] > 0
