"""The distributed runtime: the sharding plan (``sharding.py``), the
expert-parallel block's differentiable collectives (``functional.py``)
and the gradient transforms (``collectives.py``)."""
