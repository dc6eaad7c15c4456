"""LoRA training on the Wan DiT/VACE: flow-match loss and train step,
LoRA adapters with a reference-style export, the step/epoch LoRA logger,
and full train-state checkpoints."""
