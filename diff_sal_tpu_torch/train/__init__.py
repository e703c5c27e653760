"""The training slice: losses and eval scores, the optimizer (optax's Adam
+ MultiStepLR + global-norm clip semantics), parameter EMA, and the train
and eval steps."""
