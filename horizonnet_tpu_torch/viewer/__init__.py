"""Visualization and 3D export of the port: raw-output strips, layout
meshes, PLY, the headless preview and the HTML viewer."""
