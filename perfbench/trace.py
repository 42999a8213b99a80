"""Reduce a torch.profiler (CUPTI) trace to what the per-layer readers
need: the device's busy seconds (the union of kernel, copy and set
intervals), device time and launches by kernel name, and the longest idle
gaps labelled by the host operation that was running when each began.
The events stay in memory; nothing is written to disk."""

from __future__ import annotations

import numpy as np

LABELLED_GAPS = 500
NOT_KERNELS = ("memcpy", "memset")


def _is_annotation(event) -> bool:
    try:
        return bool(event.is_user_annotation())
    except (AttributeError, RuntimeError):
        return False


def summarize(prof) -> dict:
    """→ {"busy_s", "kernels": {name: [seconds, launches]},
    "launches", "device_ops": [[name, s], ...] (10 longest by total),
    "idle_gaps": [[host op, s], ...] (10 largest totals)}."""
    from torch.autograd import DeviceType

    dev_iv, kernels, host = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if _is_annotation(e):
            continue
        start, end, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            dev_iv.append((start, end))
            if not any(w in name.lower() for w in NOT_KERNELS):
                rec = kernels.setdefault(name, [0.0, 0])
                rec[0] += (end - start) * 1e-9
                rec[1] += 1
        elif e.device_type() == DeviceType.CPU and not name.startswith("cuda"):
            host.append((start, end, name))
    if not dev_iv:
        return {"busy_s": 0.0, "kernels": {}, "launches": 0,
                "device_ops": [], "idle_gaps": []}
    iv = np.array(sorted(dev_iv), dtype=np.int64)
    merged_end = np.maximum.accumulate(iv[:, 1])
    # a gap opens where an interval starts after every earlier one has ended
    gap_at = np.nonzero(iv[1:, 0] > merged_end[:-1])[0]
    gap_start, gap_len = merged_end[gap_at], iv[gap_at + 1, 0] - merged_end[gap_at]
    span = int(merged_end[-1] - iv[0, 0])
    busy = span - int(gap_len.sum())
    labels = {}
    if host and len(gap_len):
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        for g in np.argsort(gap_len)[::-1][:LABELLED_GAPS]:
            inside = np.nonzero((hs <= gap_start[g]) & (he >= gap_start[g]))[0]
            name = host[inside[np.argmax(hs[inside])]][2] if len(inside) else "(no host op)"
            labels[name] = labels.get(name, 0.0) + float(gap_len[g]) * 1e-9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy * 1e-9, "kernels": kernels,
            "launches": sum(v[1] for v in kernels.values()),
            "device_ops": [[n, v[0]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in sorted(labels.items(), key=lambda kv: -kv[1])[:10]]}
