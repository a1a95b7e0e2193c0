"""Training of the port: step, schedule, engine and checkpoint IO."""
