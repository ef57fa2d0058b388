"""Multi-device runs on ``torch.distributed``: the process groups and the
``(dp, mp)`` device mesh (`mesh.py`), and ring attention over a mesh axis
(`ring_attention.py`)."""
