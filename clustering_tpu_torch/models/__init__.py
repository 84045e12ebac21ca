"""Per-mode drivers; only density runs on the device."""
