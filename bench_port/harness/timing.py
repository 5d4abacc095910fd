"""Device timing and the table of peaks.

``cuda_ms`` is the method of the repository's on-card smoke test, kept here
so that the yardstick does not move with the program: the L2 is evicted
before every timed call by a reduction that reads a buffer larger than the
50 MB L2 (it leaves only clean lines), then a spin of about 1 ms keeps the
stream busy while the host enqueues the call, so a call whose enqueue takes
longer than the flush is still timed on the device alone.
"""

from __future__ import annotations

import gc
import subprocess

import torch

SPIN_CYCLES = 2_000_000     # ~1 ms on an H100
FLUSH_BYTES = 256 << 20     # five times the H100's 50 MB L2

# published peaks (NVIDIA data sheets): memory bytes/s and float32 FLOP/s
# outside the tensor cores, by card name; the first match wins
PEAKS = (("H200", 4.8e12, 67e12, "H200 SXM"),
         ("H100 NVL", 3.9e12, 60e12, "H100 NVL"),
         ("H100 PCIe", 2.0e12, 51e12, "H100 PCIe"),
         ("H100", 3.35e12, 67e12, "H100 SXM"))


def card_peak(name: str):
    """(bytes/s, float32 FLOP/s, label) published for the card ``name``, or
    None for a card not in the table."""
    for key, bw, flops, label in PEAKS:
        if key in name:
            return bw, flops, label
    return None


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def card_state() -> str:
    """SM and memory clocks, power draw and temperature (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()


def flush_buffer(device) -> torch.Tensor:
    return torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def cuda_ms(fn, reps: int = 20, warm: int = 3, flush=None) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` warm calls, each
    between its own pair of CUDA events; with ``flush`` (from
    :func:`flush_buffer`) the L2 is evicted and the stream spun before each
    call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.sum()
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def capture(fn, device, warm: int = 3) -> torch.cuda.CUDAGraph:
    """``fn`` captured in a CUDA graph, after ``warm`` calls on the capture
    stream, with the garbage collector off under capture (a collected
    object that frees device memory would break it)."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            fn()
    finally:
        if collecting:
            gc.enable()
    torch.cuda.synchronize(device)
    return graph
