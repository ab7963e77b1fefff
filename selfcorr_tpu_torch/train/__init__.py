"""Training: the five-group AdamW + OneCycle optimizer (optim.py), the
train state and step (step.py), and the trainer loop with the entry point
`python -m selfcorr_tpu_torch.train` (loop.py)."""
