"""Training of the port: the single-device `hybrid_gpt` step."""
