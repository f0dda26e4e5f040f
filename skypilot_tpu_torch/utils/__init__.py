"""The port's copies of the reference's `skypilot_tpu/utils` helpers it
needs (the `service:` schema)."""
