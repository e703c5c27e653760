"""The VGGish log-mel audio frontend: the host path in numpy and the
batched device path in torch (`mel`), and the 'spec' and 'ori' audio
feature types (`features`)."""
