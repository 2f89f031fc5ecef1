"""Multi-GPU execution: the process mesh (``mesh.py``) and the rules that
cut params and caches into each rank's shards (``sharding.py``)."""
