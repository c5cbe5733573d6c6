"""Model modules of the port; names and parameter names follow the
reference's torch `state_dict` (e.g. `backbone.backbone.dark2.0.conv`)."""
