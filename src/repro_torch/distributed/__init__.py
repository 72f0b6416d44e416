"""Distributed layout rules and collectives: the path-based sharding rule
engine and a plain device `Mesh` (`distributed.sharding`), and the int8
compressed gradient all-reduce with error feedback
(`distributed.collectives`)."""
