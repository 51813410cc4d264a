"""Frozen copies of the program's keygen and roofline arithmetic, each file
naming its source and commit."""
