"""User-facing apps of the port: the scenario runner (`dectnrp_main`)."""
