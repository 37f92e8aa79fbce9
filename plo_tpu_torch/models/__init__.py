"""Front-end pipeline and the per-frame odometry driver."""
