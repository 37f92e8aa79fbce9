"""Synthetic LiDAR scans (numpy)."""
