"""Parallelism of the port: the single-device `hybrid_gpt` train step,
MoE routing (`moe_utils`) and the serving engine's tensor- and
expert-parallel layout (`mp_layers`)."""
