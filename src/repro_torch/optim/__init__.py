from repro_torch.optim.adamw import AdamW, Sgd, cosine_schedule  # noqa: F401
