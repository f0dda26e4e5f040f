"""The port's copies of the reference's `skypilot_tpu/utils` helpers it
needs (the task YAML's and `service:` schemas, the state paths)."""
