"""Training on several cards (``torch.distributed``)."""
