"""Drivers: each runs one kind of traffic through the program's entry points
(see ``benchmark/harness.py`` for the interface). A traffic file names its
driver by module name."""
