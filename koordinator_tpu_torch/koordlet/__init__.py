"""koordlet: the per-node agent (port of ``koordinator_tpu/koordlet/``).

Only ``metriccache`` is here so far: the SLO monitor and the trend engine
of the scheduler binary keep their samples in it.
"""
