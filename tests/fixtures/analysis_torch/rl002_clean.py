"""RL002 clean: the decisions are taken outside the regions and passed
in; reads outside any region are fine."""
import os

import torch


def make_step(scale: int):
    @torch.compile
    def decode_step(x):
        return x * scale
    return decode_step


def capture(g, x, static, use_tf32: bool):
    with torch.cuda.graph(g):
        static.copy_(x @ x if use_tf32 else x)


SCALE = int(os.getenv("SCALE", "1"))                   # not in a region
step = make_step(SCALE if torch.cuda.device_count() else 1)
