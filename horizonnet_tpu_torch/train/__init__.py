"""Checkpoint IO of the port (training itself is ROADMAP Queue 1 item 8)."""
