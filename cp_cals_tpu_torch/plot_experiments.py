"""Render the port's experiment results into paper-style figures (port of
the JAX repo's ``scripts/plot_experiments.py``: its figure functions,
palette and PNG names).

It reads the files the port writes on the card, never ``data/benchmarks/``:

* ``--data`` (default ``chiprun_out/experiments``): ``experiments.json``
  (``python -m cp_cals_tpu_torch.experiments``) for ``speedup.png``,
  ``jk_scale.png`` and ``defrag.png``, and ``convergence_cuda.json``
  (``python -m cp_cals_tpu_torch.studies.convergence_run``; the JAX file is
  ``convergence_tpu.json``) for ``convergence.png``;
* ``--profiles`` (default ``chiprun_out/profiles``): ``profile.json``
  (``python -m cp_cals_tpu_torch.profiles.profile_iteration``; keys
  ``mttkrp_m{m}_{method}_high``, ``pure_matmul_high``, ``peak_bf16_4096``)
  for ``mttkrp_methods.png`` and ``roofline.png``.

Titles name the card by the card line each file carries (``device`` or
``card``: its name and power limit as nvidia-smi gives them), and the
roofline's top bar is the peak measured in the profile. A file that is
absent draws no figure. matplotlib is imported in ``main``; where it is not
installed the module prints ``figures: matplotlib not installed`` and draws
nothing.

    python -m cp_cals_tpu_torch.plot_experiments [--data DIR] [--profiles DIR]
        [--out chiprun_out/figures]
"""

from __future__ import annotations

import argparse
import json
import os

# Reference data-viz palette (validated set; light mode). Categorical slots
# in fixed order; single-series charts use the sequential blue.
SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK2 = "#52514e"
MUTED = "#898781"
GRID = "#e1e0d9"
BASELINE = "#c3c2b7"
SERIES = ["#2a78d6", "#eb6834", "#1baf7a"]  # slots 1-3, never re-ordered
BLUE = SERIES[0]

SKIP_LINE = "figures: matplotlib not installed"

plt = None  # matplotlib.pyplot, bound by main


def card_of(*files: dict) -> str:
    """The card line of the first file that carries one (``card``, else
    ``device``), else "the device"."""
    for f in files:
        for key in ("card", "device"):
            if f.get(key):
                return str(f[key])
    return "the device"


def _style(ax, xgrid=False, ygrid=False):
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    ax.spines["bottom"].set_color(BASELINE)
    ax.tick_params(colors=MUTED, labelcolor=INK2, length=0)
    if xgrid:
        ax.xaxis.grid(True, color=GRID, linewidth=1.0)
        ax.set_axisbelow(True)
    if ygrid:
        ax.yaxis.grid(True, color=GRID, linewidth=1.0)
        ax.set_axisbelow(True)
    ax.set_facecolor(SURFACE)


def _speedup_rows(exp) -> list:
    """(label, speedup) of each ALS-vs-CALS comparison in the file: the
    size grid (the JAX script's 100^3-300^3, and the port's quick 50^3),
    then NNLS."""
    rows = []
    for key in ("50x50x50", "100x100x100", "200x200x200", "300x300x300", "nnls"):
        if key in exp:
            d = key.split("x")[0]
            n = exp[key].get("n_models", 100 if key == "nnls" else 400)
            label = f"NNLS · {n} models" if key == "nnls" else f"{d}³ · {n} models"
            rows.append((label, exp[key]["speedup"]))
    return rows


def fig_speedup(exp, path):
    """ALS vs CALS wall-time speedup per workload (single measure -> one
    sequential hue; values direct-labeled at the bar tips)."""
    rows = _speedup_rows(exp)
    if not rows:
        return
    fig, ax = plt.subplots(figsize=(6.4, 0.62 * len(rows) + 1.5))
    fig.set_facecolor(SURFACE)
    ys = range(len(rows))
    ax.barh(list(ys), [v for _, v in rows], height=0.34, color=BLUE, linewidth=0)
    for y, (_, v) in zip(ys, rows):
        ax.text(v + 0.08, y, f"{v:.2f}×", va="center", color=INK, fontsize=10, fontweight="semibold")
    ax.axvline(1.0, color=BASELINE, linewidth=1.0)
    ax.text(1.02, -0.52, "batched ALS = 1×", color=MUTED, fontsize=8, ha="left", va="top")
    ax.set_yticks(list(ys), [r[0] for r in rows])
    ax.set_ylim(-0.6, len(rows) - 0.4)
    ax.set_xlim(0, max(v for _, v in rows) * 1.18)
    ax.invert_yaxis()
    _style(ax, xgrid=True)
    ax.set_title(f"CALS speedup over batched ALS\n(same inputs, {card_of(exp)})",
                 color=INK, fontsize=11, loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def fig_jk_scale(exp, path):
    """Jackknife throughput across tensor sizes (magnitude -> one hue)."""
    jk = exp.get("jackknife_scale", {})
    if not jk:
        return
    rows = [(k.replace("x", "×"), v["replicates_per_sec"]) for k, v in jk.items()]
    fig, ax = plt.subplots(figsize=(6.4, 0.62 * len(rows) + 1.5))
    fig.set_facecolor(SURFACE)
    ys = range(len(rows))
    ax.barh(list(ys), [v for _, v in rows], height=0.34, color=BLUE, linewidth=0)
    for y, (_, v) in zip(ys, rows):
        ax.text(v + 2, y, f"{v:.0f}/s", va="center", color=INK, fontsize=10, fontweight="semibold")
    ax.set_yticks(list(ys), [r[0] for r in rows])
    ax.set_ylim(-0.6, len(rows) - 0.4)
    ax.set_xlim(0, max(v for _, v in rows) * 1.18)
    ax.invert_yaxis()
    _style(ax, xgrid=True)
    ax.set_title(f"Jackknife replicates fitted per second\n(leave-one-out refits, one concurrent run)\n"
                 f"{card_of(exp)}", color=INK, fontsize=11, loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def fig_mttkrp(profile, path):
    """MTTKRP method comparison per mode (two series -> categorical
    slots 1-2 + legend; grouped columns)."""
    modes, methods = [0, 1, 2], ["krp_gemm", "twostep"]
    vals = {}
    for m in modes:
        for meth in methods:
            rec = profile.get(f"mttkrp_m{m}_{meth}_high")
            if rec and rec.get("tflops") is not None:
                vals[(m, meth)] = rec["tflops"]
    if not vals:
        return
    fig, ax = plt.subplots(figsize=(6.4, 3.4))
    fig.set_facecolor(SURFACE)
    w = 0.2
    for j, meth in enumerate(methods):
        xs = [m + (j - 0.5) * (w + 0.03) for m in modes]
        hs = [vals.get((m, meth), 0.0) for m in modes]
        ax.bar(xs, hs, width=w, color=SERIES[j], label=meth, linewidth=0)
        for x, h in zip(xs, hs):
            ax.text(x, h + 0.3, f"{h:.1f}", ha="center", color=INK2, fontsize=9)
    ax.set_xticks(modes, [f"mode {m}" for m in modes])
    ax.set_ylabel("TFLOP/s (fp32 via three bf16 products, 'high')", color=INK2, fontsize=9)
    _style(ax, ygrid=True)
    ax.legend(frameon=False, loc="upper left", fontsize=9, labelcolor=INK2)
    shape = "×".join(str(m) for m in profile.get("modes", []))
    ax.set_title(f"Batched MTTKRP throughput by method\n{shape}, "
                 f"B·R = {profile.get('batch', '?')}·{profile.get('rank', '?')}, {card_of(profile)}",
                 color=INK, fontsize=11, loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def fig_convergence(conv, path):
    """fp32-on-the-card vs fp64-oracle fit agreement per model (dot plot,
    log scale, one hue)."""
    models = [m for m in conv.get("models", []) if m.get("fit_delta_vs_f64") is not None]
    if not models or conv.get("max_abs_fit_delta") is None:
        return  # convergence run was made without the fp64 oracle file
    fig, ax = plt.subplots(figsize=(6.4, 3.2))
    fig.set_facecolor(SURFACE)
    xs = [m["rank"] for m in models]
    ys = [max(abs(m["fit_delta_vs_f64"]), 1e-12) for m in models]
    ax.scatter(xs, ys, s=64, color=BLUE, edgecolors=SURFACE, linewidths=2, zorder=3)
    ax.set_yscale("log")
    ax.set_xticks(sorted(set(xs)))
    ax.set_xlabel("model rank", color=INK2, fontsize=9)
    ax.set_ylabel("|fit − fit(fp64 oracle)|", color=INK2, fontsize=9)
    _style(ax, ygrid=True)
    ax.set_title(f"Tol-driven fp32 runs match the fp64 CPU oracle\n"
                 f"(max Δfit {conv['max_abs_fit_delta']:.1e}; {card_of(conv)})", color=INK, fontsize=11,
                 loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def fig_defrag(exp, path):
    """Defrag/letter study (always_evict_first stress vs default eviction):
    two engine states of one measure -> two bars, one hue."""
    d = exp.get("defrag", {})
    if not ({"default", "defrag"} <= d.keys()):
        return
    rows = [("default eviction", d["default"]["models_per_sec"]),
            ("always_evict_first (defrag stress)", d["defrag"]["models_per_sec"])]
    fig, ax = plt.subplots(figsize=(6.4, 2.6))
    fig.set_facecolor(SURFACE)
    ys = range(len(rows))
    ax.barh(list(ys), [v for _, v in rows], height=0.34, color=BLUE, linewidth=0)
    for y, (_, v) in zip(ys, rows):
        ax.text(v + 0.5, y, f"{v:.1f} models/s", va="center", color=INK, fontsize=10, fontweight="semibold")
    ax.set_yticks(list(ys), [r[0] for r in rows])
    ax.set_ylim(-0.6, len(rows) - 0.4)
    ax.set_xlim(0, max(v for _, v in rows) * 1.45)
    ax.invert_yaxis()
    _style(ax, xgrid=True)
    ax.set_title(f"Defrag-stress study, tol-driven\n"
                 f"(eviction-churn overhead {d.get('evict_first_overhead', '?')}×)\n{card_of(exp)}",
                 color=INK, fontsize=11, loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def fig_roofline(profile, path):
    """Kernel ladder: achieved twostep MTTKRP vs a pure matmul of the same
    shape vs the card's measured bf16 peak — emphasis form (the kernel is
    the story; context bars in de-emphasis gray)."""
    best_ts = max((profile[k]["tflops"] for k in profile
                   if k.startswith("mttkrp_m") and k.endswith("_twostep_high") and profile[k].get("tflops")),
                  default=None)
    mm = profile.get("pure_matmul_high", {}).get("tflops")
    peak = profile.get("peak_bf16_4096", {}).get("tflops")
    if best_ts is None or mm is None or peak is None:
        return
    card = card_of(profile)
    rows = [("MTTKRP twostep (best mode)", best_ts, BLUE),
            ("pure matmul, same shape", mm, MUTED),
            ("measured peak (bf16 4096³)", peak, MUTED)]
    fig, ax = plt.subplots(figsize=(6.4, 2.8))
    fig.set_facecolor(SURFACE)
    ys = range(len(rows))
    for y, (_, v, c) in zip(ys, rows):
        ax.barh(y, v, height=0.34, color=c, linewidth=0)
        ax.text(v + 2, y, f"{v:.0f} TF/s", va="center", color=INK, fontsize=10, fontweight="semibold")
    ax.set_yticks(list(ys), [r[0] for r in rows])
    ax.set_ylim(-0.6, len(rows) - 0.4)
    ax.set_xlim(0, max(v for _, v, _c in rows) * 1.22)
    ax.invert_yaxis()
    _style(ax, xgrid=True)
    ax.set_title(f"Kernel throughput ladder, fp32 via bf16 'high'\n{card}\n"
                 f"(peak measured by profiles/profile_iteration.py)",
                 color=INK, fontsize=10, loc="left", pad=10)
    fig.tight_layout()
    fig.savefig(path, dpi=160, facecolor=SURFACE)
    plt.close(fig)


def main(argv=None) -> list[str]:
    """Draw the figures; returns the paths written (none without matplotlib)."""
    global plt
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default=os.path.join("chiprun_out", "experiments"))
    p.add_argument("--profiles", default=os.path.join("chiprun_out", "profiles"))
    p.add_argument("--out", default=os.path.join("chiprun_out", "figures"))
    args = p.parse_args(argv)
    try:
        import matplotlib
    except ImportError:
        print(SKIP_LINE, flush=True)
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot

    plt = matplotlib.pyplot
    os.makedirs(args.out, exist_ok=True)

    def load(root, name):
        path = os.path.join(root, name)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    exp = load(args.data, "experiments.json")
    prof = load(args.profiles, "profile.json")
    conv = load(args.data, "convergence_cuda.json")
    draw = [(fig_speedup, exp, "speedup.png"), (fig_jk_scale, exp, "jk_scale.png"),
            (fig_defrag, exp, "defrag.png"), (fig_mttkrp, prof, "mttkrp_methods.png"),
            (fig_roofline, prof, "roofline.png"), (fig_convergence, conv, "convergence.png")]
    written = []
    for fig, data, name in draw:
        path = os.path.join(args.out, name)
        if os.path.exists(path):
            os.remove(path)  # a figure of an earlier run
        if data:
            fig(data, path)
            if os.path.exists(path):
                written.append(path)
    print(f"figures -> {args.out}: {', '.join(os.path.basename(w) for w in written) or 'none'}", flush=True)
    return written


if __name__ == "__main__":
    main()
