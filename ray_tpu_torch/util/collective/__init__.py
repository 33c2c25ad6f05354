"""Collective communication among actors and tasks.

Only the KV rendezvous (`rendezvous.py`) is ported so far: the Train stack
polls its wait telemetry. The collective API itself (NCCL groups, the
counterpart of the JAX package's XLA and TCP groups) is ROADMAP.md Queue 1
item 5.
"""
