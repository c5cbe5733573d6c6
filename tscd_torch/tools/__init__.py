"""Command-line tools of the port (`python -m tscd_torch.tools.<name>`)."""
