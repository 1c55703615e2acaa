"""Runs over several devices (`mesh`) and several processes (`multihost`)."""
