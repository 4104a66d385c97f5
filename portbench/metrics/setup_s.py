"""Set-up: process start to the window's open (weights made, quantized,
engine built and warmed, the warm-up requests, the mix's ramp)."""


def read(run):
    return run.out["setup_s"]
