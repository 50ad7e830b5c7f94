"""Frozen copies of the scene generators the traffic is made from."""
