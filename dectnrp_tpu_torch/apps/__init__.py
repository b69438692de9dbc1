"""User-facing apps of the port: the scenario runner (`dectnrp_main`), the
UDP round-trip tester (`rtt`) and the deadline-scheduled UDP generator
(`sync_gen`)."""
