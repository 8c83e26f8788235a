"""Parallelism of the port: the `hybrid_gpt` train step (dense or MoE,
over a (dp, pp, mp, ep) mesh of `torch.distributed` ranks), MoE routing
and the expert all-to-all (`moe_utils`), ring attention over a
context-parallel group (`ring_attention`) and the serving engine's
tensor- and expert-parallel layout (`mp_layers`)."""
