"""Launchers of the port: ``launch.train`` (one card).  The reference's
dry-run, cost, mesh, sharding and report tooling waits for ROADMAP.md queue
1 item 14."""
