"""Test and benchmark helpers of the port."""
