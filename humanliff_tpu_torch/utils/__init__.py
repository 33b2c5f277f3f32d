"""Image and video writers, logging, configuration, runtime setup and timing."""
