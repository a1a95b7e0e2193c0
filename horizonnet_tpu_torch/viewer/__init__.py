"""Visualization of the port: the raw-output strip of the inference CLI.
The layout meshes and PLY export are ROADMAP Queue 1 item 11."""
