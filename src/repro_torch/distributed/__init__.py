"""Placement of stacked tables on the serving mesh (``sharding.py``), the
train and decode steps (``steps.py``), gradient compression
(``compression.py``) and fault tolerance (``fault_tolerance.py``)."""
