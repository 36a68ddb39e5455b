"""Serving-side surgery on packed parameter trees."""
