"""Result-analysis artifacts (counterpart of `aux_ssm_tpu/experiments/figures.py`):
the tables and figures of the drivers' saved outputs.

- `sv_style_comparison`, `spatial_style_comparison`: per-time-step EJSD and
  EJSD per unit of time per iteration across sampler styles;
- `lorenz_freq_comparison`: theta's posterior and the throughput across
  smoothing frequencies;
- `rare_event_heatmaps`: moment-error and ESS heatmaps over the (rho, r^2)
  grid.

The tables are built with NumPy, returned as dicts of NumPy columns and
written as CSV with the standard library, under the JAX package's file names
and columns. matplotlib is needed only to draw: a figure is drawn when
matplotlib can be imported, and left out otherwise.

A style's EJSD is summed over every non-time axis, so the spatial kalman
styles' (T, B, 1) EJSD counts all B components (the JAX package sums over
the last axis only).
"""
import csv
import os

import numpy as np


def _ensure_dir(d):
    os.makedirs(d, exist_ok=True)
    return d


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None when matplotlib is not
    installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _cell(v):
    v = v.item() if isinstance(v, np.generic) else v
    return repr(v) if isinstance(v, float) else v


def _write_csv(path, columns):
    """Write a dict of equal-length columns as CSV (a header row, then one
    row per index)."""
    names = list(columns)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        for row in zip(*(columns[n] for n in names)):
            w.writerow([_cell(v) for v in row])


def _read_csv(path):
    """The rows of a CSV as dicts, numeric fields as floats."""
    def value(s):
        try:
            return float(s)
        except ValueError:
            return s
    with open(path, newline="") as f:
        return [{k: value(v) for k, v in row.items()} for row in csv.DictReader(f)]


def _per_time(ejsd):
    """A (T, ...) EJSD summed over every axis but time."""
    ejsd = np.asarray(ejsd)
    return ejsd.reshape(ejsd.shape[0], -1).sum(-1) if ejsd.ndim > 1 else ejsd


def _style_comparison(results, n_samples, out_dir, names):
    ejsd_path, eff_path, fig_path = (os.path.join(_ensure_dir(out_dir), n) for n in names)
    ejsd_cols, eff_cols = {}, {}
    for style, res in results.items():
        per_t = _per_time(res["ejsd"])
        ejsd_cols[style] = per_t
        eff_cols[style] = per_t / (float(res["sampling_time"]) / n_samples)
    t = np.arange(len(next(iter(ejsd_cols.values()))))
    ejsd_tab, eff_tab = {"t": t, **ejsd_cols}, {"t": t, **eff_cols}
    _write_csv(ejsd_path, ejsd_tab)
    _write_csv(eff_path, eff_tab)

    plt = _pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 2, figsize=(12, 4), sharex=True)
        for style in ejsd_cols:
            axes[0].plot(t, ejsd_tab[style], label=style)
            axes[1].plot(t, eff_tab[style], label=style)
        axes[0].set(title="EJSD per time step", xlabel="t", ylabel="EJSD")
        axes[1].set(title="EJSD / time-per-iteration", xlabel="t", ylabel="EJSD/s",
                    yscale="log")
        axes[1].legend(frameon=False, fontsize=8)
        fig.tight_layout()
        fig.savefig(fig_path, dpi=150)
        plt.close(fig)
    return ejsd_tab, eff_tab


def sv_style_comparison(results, n_samples, out_dir):
    """results: {style: dict(ejsd=(T, ...) array, sampling_time=float)}.

    Writes ESJD.csv, ESJD_time.csv and sv_ejsd.png; returns the two tables
    (EJSD per time step summed over components, and that divided by the
    per-iteration wall time)."""
    return _style_comparison(results, n_samples, out_dir,
                             ("ESJD.csv", "ESJD_time.csv", "sv_ejsd.png"))


def spatial_style_comparison(results, n_samples, out_dir):
    """The same analysis for the spatial model (EJSD summed over the B = D^2
    components), as spatial_ESJD.csv, spatial_ESJD_time.csv and
    spatial_ejsd.png."""
    return _style_comparison(results, n_samples, out_dir,
                             ("spatial_ESJD.csv", "spatial_ESJD_time.csv",
                              "spatial_ejsd.png"))


def lorenz_freq_comparison(results, out_dir):
    """results: {freq: dict(theta_samples=(n, 3) or (n_chains, n, 3),
    ejsd=(T, d) or (T,), sampling_time=float)}. Writes lorenz_theta.csv (per
    frequency theta's posterior mean and std and the throughput and EJSD
    summary) and lorenz_theta.png (theta's histograms and traces); returns
    the table."""
    _ensure_dir(out_dir)
    names = ["theta1", "theta2", "theta3"]
    rows = []
    for freq, res in sorted(results.items()):
        th = np.asarray(res["theta_samples"])
        if th.ndim == 3:                       # (n_chains, n, 3) -> pooled
            th = th.reshape(-1, th.shape[-1])
        ejsd = np.asarray(res["ejsd"])
        t_iter = float(res["sampling_time"]) / max(len(th), 1)
        rows.append({"freq": freq, "n_samples": len(th), "time_per_iter_s": t_iter,
                     "mean_ejsd": float(ejsd.mean()),
                     "ejsd_per_sec": float(ejsd.mean() / t_iter),
                     **{f"{n}_mean": float(th[:, i].mean()) for i, n in enumerate(names)},
                     **{f"{n}_std": float(th[:, i].std()) for i, n in enumerate(names)}})
    table = {k: np.asarray([r[k] for r in rows]) for k in rows[0]}
    _write_csv(os.path.join(out_dir, "lorenz_theta.csv"), table)

    plt = _pyplot()
    if plt is not None:
        fig, axes = plt.subplots(2, 3, figsize=(13, 7))
        for i, name in enumerate(names):
            for freq, res in sorted(results.items()):
                th = np.asarray(res["theta_samples"]).reshape(-1, 3)
                axes[0, i].hist(th[:, i], bins=60, density=True, alpha=0.5,
                                label=f"freq={freq}")
                axes[1, i].plot(th[:, i], lw=0.4, alpha=0.7, label=f"freq={freq}")
            axes[0, i].set(title=f"{name} posterior", xlabel=name)
            axes[1, i].set(title=f"{name} trace", xlabel="iteration")
        axes[0, 0].legend(frameon=False, fontsize=8)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "lorenz_theta.png"), dpi=150)
        plt.close(fig)
    return table


def rare_event_heatmaps(rows, out_dir, stem="rare_event"):
    """rows: one dict a grid cell (keys rho, r2, err_mean_0/T, err_std_0/T,
    ess_0/T, acc, ...). Writes `<stem>_summary.csv` and a 2x2 log-scale
    heatmap figure (normalised squared mean error and ESS at t=0 and t=T);
    returns the table."""
    _ensure_dir(out_dir)
    keys = list(dict.fromkeys(k for r in rows for k in r))
    table = {k: np.asarray([r.get(k, np.nan) for r in rows]) for k in keys}
    _write_csv(os.path.join(out_dir, f"{stem}_summary.csv"), table)

    plt = _pyplot()
    if plt is not None:
        from matplotlib.colors import LogNorm
        rhos, r2s = np.unique(table["rho"]), np.unique(table["r2"])
        panels = [("err_mean_0", "normalised sq. mean error, t=0"),
                  ("err_mean_T", "normalised sq. mean error, t=T"),
                  ("ess_0", "ESS, t=0"), ("ess_T", "ESS, t=T")]
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        for ax, (col, title) in zip(axes.ravel(), panels):
            grid = np.full((len(rhos), len(r2s)), np.nan)
            grid[np.searchsorted(rhos, table["rho"]),
                 np.searchsorted(r2s, table["r2"])] = table[col]
            im = ax.imshow(np.maximum(grid, 1e-12), origin="lower", aspect="auto",
                           cmap="viridis", norm=LogNorm(),
                           extent=[np.log10(r2s.min()), np.log10(r2s.max()),
                                   rhos.min(), rhos.max()])
            ax.set(title=title, xlabel="log10 r2", ylabel="rho")
            fig.colorbar(im, ax=ax, shrink=0.85)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{stem}_heatmaps.png"), dpi=150)
        plt.close(fig)
    return table


def main(argv=None):
    """CLI: build the analysis artifacts from saved driver outputs.

        python -m aux_ssm_tpu_torch.experiments.figures sv \\
            --run kalman-1=out_k1.npz --run csmc=out_csmc.npz \\
            --n-samples 10000 --out-dir results/
        python -m aux_ssm_tpu_torch.experiments.figures rare-event \\
            --summary rare_event.csv --out-dir results/

    Without matplotlib it writes the tables only."""
    import argparse
    p = argparse.ArgumentParser(description=main.__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for cmd in ("sv", "spatial"):
        q = sub.add_parser(cmd)
        q.add_argument("--run", action="append", required=True, metavar="STYLE=PATH.npz")
        q.add_argument("--n-samples", type=int, required=True)
    q = sub.add_parser("lorenz")
    q.add_argument("--run", action="append", required=True, metavar="FREQ=PATH.npz")
    q = sub.add_parser("rare-event")
    q.add_argument("--summary", required=True, help="the grid driver's CSV output")
    for q in sub.choices.values():
        q.add_argument("--out-dir", default="results")

    args = p.parse_args(argv)
    if args.cmd in ("sv", "spatial"):
        results = {}
        for spec in args.run:
            style, path = spec.split("=", 1)
            data = np.load(path)
            results[style] = dict(ejsd=data["ejsd"], sampling_time=float(data["sampling_time"]))
        fn = sv_style_comparison if args.cmd == "sv" else spatial_style_comparison
        fn(results, args.n_samples, args.out_dir)
        print(f"wrote ESJD / ESJD_time / ejsd figure to {args.out_dir}")
    elif args.cmd == "lorenz":
        results = {}
        for spec in args.run:
            freq, path = spec.split("=", 1)
            data = np.load(path)
            results[int(freq)] = dict(theta_samples=data["theta_samples"], ejsd=data["ejsd"],
                                      sampling_time=float(data["sampling_time"]))
        lorenz_freq_comparison(results, args.out_dir)
        print(f"wrote lorenz_theta.csv / lorenz_theta.png to {args.out_dir}")
    else:
        rare_event_heatmaps(_read_csv(args.summary), args.out_dir)
        print(f"wrote rare_event_summary.csv / rare_event_heatmaps.png to {args.out_dir}")


if __name__ == "__main__":
    main()
