"""Summary-JSON → matplotlib figures (reference scripts/plot_metrics.py).

The key-string parsers are load-bearing (the reference parses its own result
keys back out of the summary files, plot_metrics.py:150-186); kept here with
tests.  Figures: AICE trade-off curves vs mom2_weight / edit count, COCO
preservation curves, artist LPIPS/CLIP bars, the ablation curves and
heatmaps, the causal-trace heatmap.

Counterpart of ``emcid_tpu/evals/plotting.py`` (plain Python, copied).
matplotlib is imported inside ``_plt`` only, so importing this module needs
none.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def parse_summary_key(key: str) -> Dict[str, float]:
    """``edit30_weight4000_ew0.6`` / ``edit_30_weight4000`` → fields
    (reference extract_edit_num_and_mom2_weight, plot_metrics.py:150-186)."""
    m = re.match(
        r"edit_?(\d+)_weight(\d+(?:\.\d+)?)(?:_ew(\d*\.?\d+))?$", key
    )
    if not m:
        raise ValueError(f"unparsable summary key {key!r}")
    return {
        "num_edit": int(m.group(1)),
        "mom2_weight": float(m.group(2)),
        "edit_weight": float(m.group(3)) if m.group(3) else 0.5,
    }


def load_summary_records(path) -> List[Dict]:
    with open(path) as f:
        summary = json.load(f)
    rows = []
    for key, record in summary.items():
        try:
            fields = parse_summary_key(key)
        except ValueError:
            continue
        rows.append({**fields, **record, "key": key})
    return rows


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_tradeoff_vs_edit_num(
    summary_path,
    out_file,
    metrics: Tuple[str, ...] = (
        "post_source_cls_score_edit",
        "post_dest_cls_score_edit",
        "post_source_cls_score_general",
        "post_cls_score_specificity",
    ),
    mom2_weight: Optional[float] = None,
):
    """Metric curves vs number of edits at a fixed lambda."""
    plt = _plt()
    rows = load_summary_records(summary_path)
    if mom2_weight is not None:
        rows = [r for r in rows if r["mom2_weight"] == mom2_weight]
    rows.sort(key=lambda r: r["num_edit"])
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = [r["num_edit"] for r in rows]
    for metric in metrics:
        ys = [r.get(metric) for r in rows]
        if any(y is not None for y in ys):
            ax.plot(xs, ys, marker="o", label=metric)
    ax.set_xlabel("number of edits")
    ax.set_ylabel("score")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def plot_tradeoff_vs_mom2(summary_path, out_file,
                          metrics=("post_source_cls_score_edit",
                                   "post_cls_score_specificity"),
                          num_edit: Optional[int] = None):
    plt = _plt()
    rows = load_summary_records(summary_path)
    if num_edit is not None:
        rows = [r for r in rows if r["num_edit"] == num_edit]
    rows.sort(key=lambda r: r["mom2_weight"])
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = [r["mom2_weight"] for r in rows]
    for metric in metrics:
        ys = [r.get(metric) for r in rows]
        if any(y is not None for y in ys):
            ax.plot(xs, ys, marker="s", label=metric)
    ax.set_xlabel("mom2_update_weight (lambda)")
    ax.set_ylabel("score")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def plot_coco_preservation(coco_summary_path, out_file):
    """FID / CLIP / LPIPS vs edit count (reference plot_metrics COCO legs)."""
    plt = _plt()
    rows = load_summary_records(coco_summary_path)
    rows.sort(key=lambda r: r["num_edit"])
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    for ax, metric in zip(axes, ("fid", "clip_vit_large", "lpips")):
        xs = [r["num_edit"] for r in rows if metric in r]
        ys = [r[metric] for r in rows if metric in r]
        ax.plot(xs, ys, marker="o")
        ax.set_xlabel("number of edits")
        ax.set_title(metric)
        ax.grid(alpha=0.3)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


def _save(fig, out_file):
    plt = _plt()
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file


# ---------------------------------------------------------------------------
# artists summary (reference eval_artists.py:118-309 schema:
# keys "edit_{n}_weight{w}[_ew{e}]" / "sd_orig_{n}"; values hold
# edit_lpips / hold_out_lpips / edit_clip / hold_out_clip as {mean, std})
# ---------------------------------------------------------------------------

def load_artists_summary(path, max_x: int = 300):
    """→ (rows sorted by edit_num, sd_orig record or None)."""
    with open(path) as f:
        summary = json.load(f)
    rows, orig = [], None
    for key, rec in summary.items():
        if key.startswith("sd_orig"):
            orig = rec
            continue
        try:
            fields = parse_summary_key(key)
        except ValueError:
            continue
        if fields["num_edit"] > max_x:
            continue
        rows.append({**fields, **rec, "key": key})
    rows.sort(key=lambda r: r["num_edit"])
    return rows, orig


def plot_artists_lpips_clip(
    summary_paths,
    out_file,
    plot_clip: bool = True,
    plot_std: bool = True,
    max_x: int = 300,
    orig_summary_path=None,
):
    """LPIPS (erased vs holdout, ±std band) and CLIP curves vs edit count
    (reference plot_lpips_and_clip_artists, plot_metrics.py:1574-1925).

    ``summary_paths``: {label: artists_summary.json path}.  The optional
    ``orig_summary_path`` adds the unedited-SD CLIP score as a dashed line
    (reference reads results/sd_orig/artists/artists_summary.json).
    """
    plt = _plt()
    if not isinstance(summary_paths, dict):
        summary_paths = {Path(p).parent.parent.name: p for p in summary_paths}
    n_axes = 2 if plot_clip else 1
    fig, axes = plt.subplots(n_axes, 1, figsize=(4, 3 * n_axes),
                             sharex=True, squeeze=False)
    axes = axes[:, 0]
    for label, path in summary_paths.items():
        rows, _ = load_artists_summary(path, max_x=max_x)
        xs = [r["num_edit"] for r in rows]
        for kind, style in (("edit", "-"), ("hold_out", "--")):
            mean = [r[f"{kind}_lpips"]["mean"] for r in rows]
            line, = axes[0].plot(xs, mean, style, marker="o", markersize=3,
                                 label=f"{label} {kind}")
            if plot_std:
                lo = [r[f"{kind}_lpips"]["mean"] - r[f"{kind}_lpips"]["std"]
                      for r in rows]
                hi = [r[f"{kind}_lpips"]["mean"] + r[f"{kind}_lpips"]["std"]
                      for r in rows]
                axes[0].fill_between(xs, lo, hi, alpha=0.15,
                                     color=line.get_color())
            if plot_clip:
                clip = [r[f"{kind}_clip"]["mean"] for r in rows]
                axes[1].plot(xs, clip, style, marker="o", markersize=3,
                             color=line.get_color())
    axes[0].set_ylabel("LPIPS (pre vs post)")
    if plot_clip:
        if orig_summary_path is not None:
            with open(orig_summary_path) as f:
                orig = json.load(f)
            rec = next((v for k, v in orig.items()
                        if k.startswith("sd_orig")), None)
            if rec is not None and "edit_clip" in rec:
                axes[1].axhline(rec["edit_clip"]["mean"], color="gray",
                                linestyle=":", label="SD orig")
        axes[1].set_ylabel("CLIP score")
        axes[1].set_xlabel("number of edited artists")
    else:
        axes[0].set_xlabel("number of edited artists")
    for ax in axes:
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=6)
    fig.subplots_adjust(hspace=0)
    return _save(fig, out_file)


def plot_coco_multi(
    summary_paths,
    out_file,
    plot_lpips: bool = False,
    max_x: int = 300,
    direction: str = "vertical",
):
    """Multi-hparam COCO preservation: CLIP + FID (+LPIPS) vs edit count,
    one curve per summary (reference plot_clip_and_fid_coco,
    plot_metrics.py:1309-1572; coco_summary.json records carry
    lpips.mean / clip_vit_large.mean / fid)."""
    plt = _plt()
    if not isinstance(summary_paths, dict):
        summary_paths = {Path(p).parent.parent.name: p for p in summary_paths}
    panels = ["clip_vit_large", "fid"] + (["lpips"] if plot_lpips else [])
    if direction == "vertical":
        fig, axes = plt.subplots(len(panels), 1,
                                 figsize=(2.5, 2.2 * len(panels)),
                                 squeeze=False)
        axes = axes[:, 0]
    else:
        fig, axes = plt.subplots(1, len(panels),
                                 figsize=(3 * len(panels), 2.2),
                                 squeeze=False)
        axes = axes[0]
    for label, path in summary_paths.items():
        rows = load_summary_records(path)
        rows = [r for r in rows if r["num_edit"] <= max_x]
        rows.sort(key=lambda r: r["num_edit"])
        xs = [r["num_edit"] for r in rows]
        for ax, metric in zip(axes, panels):
            # records store lpips/clip as {mean, std} dicts, fid as a scalar
            # (reference eval_coco.py); accept scalars for either
            vals = [r.get(metric) for r in rows]
            ys = [v.get("mean") if isinstance(v, dict) else v for v in vals]
            ax.plot(xs, ys, marker="o", markersize=3, label=label)
    titles = {"clip_vit_large": "CLIP score", "fid": "FID", "lpips": "LPIPS"}
    for ax, metric in zip(axes, panels):
        ax.set_title(titles[metric], fontsize=9)
        ax.grid(alpha=0.3)
    axes[-1].set_xlabel("number of edits")
    axes[0].legend(fontsize=6)
    return _save(fig, out_file)


def plot_debias_ratios(csv_path, out_file):
    """Gender-ratio bars per profession + delta error bars from the
    eval_ratios CSV (reference eval_debias.py:275-370 writes columns
    female / male / delta / delta_std indexed by profession, with a final
    'total' row)."""
    import csv as _csv

    plt = _plt()
    rows = []
    with open(csv_path) as f:
        for rec in _csv.DictReader(f):
            name = rec.get("") or rec.get("profession") or rec.get("key")
            rows.append((name, rec))
    total = next((r for n, r in rows if n == "total"), None)
    rows = [(n, r) for n, r in rows if n != "total"]
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(max(6, 0.5 * len(rows)), 3))
    idx = range(len(rows))
    ax0.bar([i - 0.2 for i in idx],
            [float(r["female"]) for _, r in rows], 0.4, label="female")
    ax0.bar([i + 0.2 for i in idx],
            [float(r["male"]) for _, r in rows], 0.4, label="male")
    ax0.axhline(0.5, color="gray", linestyle=":")
    ax0.set_xticks(list(idx))
    ax0.set_xticklabels([n for n, _ in rows], rotation=60, fontsize=6,
                        ha="right")
    ax0.set_ylabel("ratio")
    ax0.legend(fontsize=7)
    ax1.bar(list(idx), [float(r["delta"]) for _, r in rows],
            yerr=[float(r.get("delta_std") or 0) for _, r in rows],
            capsize=2)
    if total is not None:
        ax1.axhline(float(total["delta"]), color="red", linestyle="--",
                    label=f"total {float(total['delta']):.2f}")
        ax1.legend(fontsize=7)
    ax1.set_xticks(list(idx))
    ax1.set_xticklabels([n for n, _ in rows], rotation=60, fontsize=6,
                        ha="right")
    ax1.set_ylabel("deviation |ratio-0.5|/0.5")
    fig.tight_layout()
    return _save(fig, out_file)


# ---------------------------------------------------------------------------
# ablation plotters (reference experiments/ablation.py:577-1120): every
# sweep derives the same three metrics from an AICE summary record
# ---------------------------------------------------------------------------

def ablation_metrics(record: Dict) -> Dict[str, float]:
    """post−pre deltas the reference's ablation CSVs carry
    (ablation.py:176-185: general_source2dest, holdout_delta,
    average_score, alias2dest)."""
    s2d = (record["post_source_dest_cls_score_general"]
           - record["pre_source_dest_cls_score_general"])
    hod = (record["post_cls_score_specificity"]
           - record["pre_cls_score_specificity"])
    out = {
        "general_source2dest": s2d,
        "holdout_delta": hod,
        "average_score": (s2d + hod) / 2,
    }
    if "post_source_dest_cls_score_alias" in record:
        out["alias2dest"] = (record["post_source_dest_cls_score_alias"]
                             - record["pre_source_dest_cls_score_alias"])
    return out


def plot_ablation_curves(
    points: Dict[float, Dict],
    out_file,
    xlabel: str,
    metrics=("average_score", "general_source2dest", "holdout_delta"),
):
    """Derived-metric curves vs a scalar knob — serves both the edit_weight
    sweep (reference plot_edit_weight_ablation, ablation.py:144-268) and the
    num_edit_tokens sweep (plot_num_edit_token_ablation, ablation.py:697-753).

    ``points``: {x value: AICE summary record} — exactly what
    experiments.ablation.edit_weight_ablation / num_edit_tokens_ablation
    return.
    """
    plt = _plt()
    xs = sorted(points)
    derived = {x: ablation_metrics(points[x]) for x in xs}
    fig, axes = plt.subplots(1, len(metrics), figsize=(3.2 * len(metrics), 2.6))
    for ax, metric in zip(axes, metrics):
        ax.plot(xs, [derived[x][metric] for x in xs], marker="o")
        ax.set_xlabel(xlabel)
        ax.set_title(metric, fontsize=9)
        ax.set_xticks(xs)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, out_file)


def plot_layer_ablation(
    cells: Dict[Tuple[int, int], Dict],
    out_file,
    metric: str = "average_score",
):
    """(start_layer, optimize_layer) triangle heatmap (reference
    plot_layer_ablation / plot_layer_ablation_all, ablation.py:754-949,
    fed by get_csv_results_layer_ablation:577-639).

    ``cells``: {(start_layer, end_layer): AICE summary record}.
    """
    import numpy as np

    plt = _plt()
    starts = sorted({k[0] for k in cells})
    ends = sorted({k[1] for k in cells})
    grid = np.full((len(starts), len(ends)), np.nan)
    for (s, e), rec in cells.items():
        grid[starts.index(s), ends.index(e)] = ablation_metrics(rec)[metric]
    fig, ax = plt.subplots(
        figsize=(0.6 * len(ends) + 2, 0.5 * len(starts) + 1.5))
    im = ax.imshow(grid, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(ends)))
    ax.set_xticklabels(ends, fontsize=7)
    ax.set_yticks(range(len(starts)))
    ax.set_yticklabels(starts, fontsize=7)
    ax.set_xlabel("last edited layer")
    ax.set_ylabel("first edited layer")
    ax.set_title(metric, fontsize=9)
    fig.colorbar(im, ax=ax)
    return _save(fig, out_file)


def plot_heatmap(heat, tokens, out_file, title: str = "causal trace",
                 layers=None):
    """Causal-trace heatmap (reference causal_trace.py:859-937)."""
    plt = _plt()
    import numpy as np

    heat = np.asarray(heat)
    fig, ax = plt.subplots(figsize=(0.5 * heat.shape[1] + 2,
                                    0.3 * heat.shape[0] + 1.5))
    im = ax.imshow(heat, aspect="auto", cmap="Purples")
    ax.set_yticks(range(len(tokens)))
    ax.set_yticklabels(tokens, fontsize=7)
    ax.set_xlabel("restored layer")
    if layers is not None:
        ax.set_xticks(range(len(layers)))
        ax.set_xticklabels(layers, fontsize=7)
    ax.set_title(title, fontsize=9)
    fig.colorbar(im, ax=ax)
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_file
