"""Per-architecture model configs of the port (`registry.get_config`)."""
