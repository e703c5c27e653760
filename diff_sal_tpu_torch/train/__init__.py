"""Training: losses and eval scores, the optimizer (optax's Adam +
MultiStepLR + global-norm clip semantics), parameter EMA, the train and
eval steps, checkpoints, and the trainer with the AV fine-tune protocol."""
