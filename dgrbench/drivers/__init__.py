"""Drivers: one module a kind of traffic, named by a mix's ``driver`` key;
each builds the program under test, runs its window calls and hands what
they produced to the reference."""
