"""Distributed layout rules: the path-based sharding rule engine and a
plain device `Mesh` (`distributed.sharding`)."""
