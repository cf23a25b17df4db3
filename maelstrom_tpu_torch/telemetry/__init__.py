"""Device flight recorder (telemetry lanes threaded through the carry)."""
