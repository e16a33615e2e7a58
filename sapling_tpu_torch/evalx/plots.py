"""Plot generators: the eval/ plotting scripts, fed by measured data.

The reference's plots (eval/TimingPlot/plot.py, eval/Memory/plot_memory.py,
eval/VarQuery/plot_query_length_runtime.py, eval/HighlightBins/hist.py,
eval/SuffixArraySim plots) hard-code their numbers in the scripts; these
take the numbers as arguments so they plot what was actually measured.
Matplotlib only (headless Agg backend); every function writes a PNG and
returns its path.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def _finish(fig, out_png: str) -> str:
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def timing_plot(genome_sizes, series: dict[str, list[float]], out_png: str,
                ylabel: str = "queries/sec", title: str = "Query throughput"):
    """Throughput/runtime across genome sizes for several engines
    (eval/TimingPlot/plot.py shape)."""
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, ys in series.items():
        ax.plot(genome_sizes, ys, marker="o", label=name)
    ax.set_xscale("log")
    ax.set_xlabel("genome size (bp)")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    return _finish(fig, out_png)


def query_length_plot(lengths, series: dict[str, list[float]], out_png: str,
                      ylabel: str = "queries/sec"):
    """Runtime vs query length (eval/VarQuery/plot_query_length_runtime.py)."""
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, ys in series.items():
        ax.plot(lengths, ys, marker="s", label=name)
    ax.set_xlabel("query length (bp)")
    ax.set_ylabel(ylabel)
    ax.set_title("Throughput vs query length")
    ax.legend()
    return _finish(fig, out_png)


def memory_plot(labels, gigabytes, out_png: str):
    """Index memory per tool/config (eval/Memory/plot_memory.py)."""
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(range(len(labels)), gigabytes)
    ax.set_xticks(range(len(labels)), labels, rotation=30, ha="right")
    ax.set_ylabel("index memory (GB)")
    ax.set_title("Index memory")
    return _finish(fig, out_png)


def sa_shape_plot(kmers, ranks, out_png: str, title: str = "Suffix array"):
    """k-mer value vs SA rank scatter (eval/SuffixArraySample usage and
    eval/SuffixArraySim plots)."""
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(np.asarray(kmers), np.asarray(ranks), ",", alpha=0.5)
    ax.set_xlabel("k-mer value")
    ax.set_ylabel("suffix-array rank")
    ax.set_title(title)
    return _finish(fig, out_png)


def error_histogram_plot(errors, out_png: str, bins: int = 101):
    """Signed prediction-error histogram (eval/HighlightBins/hist.py)."""
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(np.asarray(errors), bins=bins)
    ax.set_yscale("log")
    ax.set_xlabel("signed prediction error (SA rows)")
    ax.set_ylabel("k-mers")
    ax.set_title("PWL prediction error distribution")
    return _finish(fig, out_png)


def bin_scatter_plot(kmers, ranks, xlist, ylist, bin_index: int, k: int,
                     buckets: int, out_png: str):
    """One bucket's (kmer, rank) points with its PWL segment overlaid
    (eval/HighlightBins/plot.sh output)."""
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(np.asarray(kmers), np.asarray(ranks), ".", ms=2, label="k-mers")
    xs = [int(xlist[bin_index]), int(xlist[bin_index + 1])]
    ys = [int(ylist[bin_index]), int(ylist[bin_index + 1])]
    ax.plot(xs, ys, "-", lw=2, label="PWL segment")
    ax.set_xlabel("k-mer value")
    ax.set_ylabel("SA rank")
    ax.set_title(f"bucket {bin_index} (k={k}, 2^{buckets} bins)")
    ax.legend()
    return _finish(fig, out_png)
