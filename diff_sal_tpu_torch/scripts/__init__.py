"""Command-line scripts: `python -m diff_sal_tpu_torch.scripts.<name>`."""
