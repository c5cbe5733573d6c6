"""Datasets and window loaders of the port."""

import os

# the committed fixtures: a 720p VID video and OVIS-format json over it
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
