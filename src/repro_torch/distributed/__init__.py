"""Placement of stacked tables on the serving mesh (``sharding.py``)."""
