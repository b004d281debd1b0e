"""Figures and ablation tables of sweep records.

The counterpart of ``flashattention_tpu/bench/plotting.py``: per-(d, causal)
TFLOP/s panels, a forward vs forward+backward figure, and the ablation
table as markdown, LaTeX and PNG. The figures name the card the records
were measured on (``device``). matplotlib (Agg backend) is imported inside
the functions only, so the package imports without it."""

from __future__ import annotations

import time
from pathlib import Path

from flashattention_tpu_torch.bench.harness import BenchRecord


def plot_sweep(records: list[BenchRecord], out_dir, tag: str,
               device: str) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ok = [r for r in records if r.status == "ok"]
    dims = sorted({r.head_dim for r in ok})
    causals = sorted({r.causal for r in ok})
    fig, axes = plt.subplots(
        len(causals), max(len(dims), 1),
        figsize=(4 * max(len(dims), 1), 3.2 * len(causals)),
        squeeze=False,
    )
    for i, causal in enumerate(causals):
        for j, d in enumerate(dims):
            ax = axes[i][j]
            sel = [r for r in ok if r.head_dim == d and r.causal == causal]
            series = sorted({(r.algo, r.backend, r.direction) for r in sel})
            for key in series:
                pts = sorted(
                    [(r.seqlen, r.tflops) for r in sel
                     if (r.algo, r.backend, r.direction) == key]
                )
                if pts:
                    ax.plot(*zip(*pts), marker="o", label="/".join(key))
            ax.set_xscale("log", base=2)
            ax.set_title(f"d={d} causal={causal}")
            ax.set_xlabel("seq len")
            ax.set_ylabel("TFLOP/s")
            ax.grid(alpha=0.3)
            if i == 0 and j == 0:
                ax.legend(fontsize=7)
    fig.suptitle(f"flashattention_tpu_torch sweep ({device})")
    fig.tight_layout()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}_{time.strftime('%Y%m%d_%H%M%S')}.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_mixed_figure(records: list[BenchRecord], out_dir, tag: str,
                      device: str) -> Path:
    """Grouped bars per sequence length, forward TFLOP/s next to
    forward+backward TFLOP/s, one panel per (head_dim, causal)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    ok = [r for r in records if r.status == "ok"]
    panels = sorted({(r.head_dim, r.causal) for r in ok})
    fig, axes = plt.subplots(
        1, max(len(panels), 1), figsize=(4.2 * max(len(panels), 1), 3.4),
        squeeze=False,
    )
    for j, (d, causal) in enumerate(panels):
        ax = axes[0][j]
        sel = [r for r in ok if r.head_dim == d and r.causal == causal]
        seqs = sorted({r.seqlen for r in sel})
        dirs = [dd for dd in ("forward", "backward")
                if any(r.direction == dd for r in sel)]
        width = 0.8 / max(len(dirs), 1)
        x = np.arange(len(seqs))
        for di, direction in enumerate(dirs):
            vals = []
            for n in seqs:
                rs = [r.tflops for r in sel
                      if r.seqlen == n and r.direction == direction]
                vals.append(max(rs) if rs else 0.0)
            label = "fwd" if direction == "forward" else "fwd+bwd"
            ax.bar(x + di * width, vals, width, label=label)
        ax.set_xticks(x + width * (len(dirs) - 1) / 2)
        ax.set_xticklabels([str(n) for n in seqs], fontsize=7)
        ax.set_title(f"d={d} causal={causal}", fontsize=9)
        ax.set_xlabel("seq len")
        ax.set_ylabel("TFLOP/s")
        ax.grid(alpha=0.3, axis="y")
        if j == 0:
            ax.legend(fontsize=7)
    fig.suptitle(f"flashattention_tpu_torch fwd vs fwd+bwd ({device})")
    fig.tight_layout()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}_mixed_{time.strftime('%Y%m%d_%H%M%S')}.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


_ABLATION_COLS = (
    "algo", "backend", "dir", "N", "d", "causal", "dtype", "ms",
    "TFLOP/s", "%roofline", "mem MB", "status",
)


def _ablation_rows(records: list[BenchRecord]) -> list[tuple[str, ...]]:
    return [
        (
            r.algo, r.backend, r.direction, str(r.seqlen), str(r.head_dim),
            str(r.causal), r.dtype, f"{r.mean_ms:.3f}", f"{r.tflops:.1f}",
            f"{100 * r.roofline_frac:.1f}%", f"{r.peak_mem_mb:.0f}", r.status,
        )
        for r in records
    ]


def ablation_table_md(records: list[BenchRecord]) -> str:
    """Markdown ablation table."""
    lines = [
        "| " + " | ".join(_ABLATION_COLS) + " |",
        "|" + "---|" * len(_ABLATION_COLS),
    ]
    for row in _ablation_rows(records):
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def ablation_table_tex(records: list[BenchRecord]) -> str:
    """LaTeX ablation table."""
    cols = [c.replace("%", r"\%") for c in _ABLATION_COLS]
    lines = [
        r"\begin{tabular}{" + "l" * len(cols) + "}",
        r"\toprule",
        " & ".join(cols) + r" \\",
        r"\midrule",
    ]
    for row in _ablation_rows(records):
        lines.append(
            " & ".join(c.replace("%", r"\%").replace("_", r"\_") for c in row)
            + r" \\"
        )
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def render_ablation_table(
    records: list[BenchRecord], out_dir, tag: str
) -> dict[str, Path]:
    """Write the ablation table as .md, .tex and .png; returns {ext: path}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    paths: dict[str, Path] = {}

    paths["md"] = out_dir / f"{tag}_ablation_{ts}.md"
    paths["md"].write_text(ablation_table_md(records) + "\n")
    paths["tex"] = out_dir / f"{tag}_ablation_{ts}.tex"
    paths["tex"].write_text(ablation_table_tex(records) + "\n")

    rows = _ablation_rows(records)
    fig_h = 0.35 * (len(rows) + 2)
    fig, ax = plt.subplots(figsize=(11, max(fig_h, 1.2)))
    ax.axis("off")
    table = ax.table(
        cellText=rows, colLabels=list(_ABLATION_COLS), loc="center",
        cellLoc="center",
    )
    table.auto_set_font_size(False)
    table.set_fontsize(7)
    table.scale(1.0, 1.2)
    fig.suptitle(f"flashattention_tpu_torch ablation — {tag}", fontsize=10)
    paths["png"] = out_dir / f"{tag}_ablation_{ts}.png"
    fig.savefig(paths["png"], dpi=140, bbox_inches="tight")
    plt.close(fig)
    return paths
