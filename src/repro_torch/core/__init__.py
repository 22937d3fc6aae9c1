"""Algorithm numerics of the port: seeding, updates, DMR, ABFT thresholds,
campaign draws and the assignment backends."""
