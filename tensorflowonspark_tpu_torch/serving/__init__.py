"""Serving tier of the port (counterpart of ``tensorflowonspark_tpu/serving``).

This slice ports the decode tier only; the ``Server``, ``ReplicaPool``
and HTTP frontend come in a later slice (ROADMAP.md).
"""
