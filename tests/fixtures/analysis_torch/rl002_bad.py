"""RL002 true positives: device and environment reads inside a compiled
or captured region — read once, replayed forever."""
import os

import torch


@torch.compile
def decode_step(x):
    if os.environ.get("USE_FAST"):                     # BAD: compiled
        return x * 2
    return x


def _pick_width():
    return 2 if torch.cuda.is_available() else 1       # BAD: via compile


def body(x):
    return x * _pick_width()


compiled = torch.compile(body)


def capture(g, x, static):
    with torch.cuda.graph(g):
        if torch.backends.cuda.matmul.allow_tf32:      # BAD: captured
            static.copy_(x @ x)


def graphed_fn(x):
    return x * int(os.getenv("SCALE", "1"))            # BAD: graphed


graphed = torch.cuda.make_graphed_callables((graphed_fn,), ((None,),))
