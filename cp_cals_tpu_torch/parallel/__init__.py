"""Multi-device runs over ``torch.distributed``: the (dp, tp) mesh
(``sharding.py``) and process-group set-up (``distributed.py``)."""
