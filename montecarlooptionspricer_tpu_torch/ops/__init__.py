"""Numerics shared by the port's models (payoff, time grid, regression)."""
