"""The whole training step's share of the chip's float32 peak, in %: the
matrix FLOPs of the window's rounds (``roofline.sac_round_flops``) over the
window's seconds (the profiler is off in the window) times the H100's
67 TFLOP/s outside the tensor cores (the nets run float32 without TF32)."""

from benchmark.roofline import PEAK_F32_PER_S


def read(record):
    flops = record.window.get("round_flops")
    if flops is None:
        return None
    return flops * record.window["rounds"] / record.window["seconds"] / PEAK_F32_PER_S * 100.0
