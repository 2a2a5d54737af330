"""RL008 clean: the one resolver may ask whether a card is there; it
raises when one is asked for and there is none."""
import torch


def resolve(device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but not available")
    return dev
