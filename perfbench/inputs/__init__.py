"""Inputs made from the run's seed: graphs, weights, request schedules."""
