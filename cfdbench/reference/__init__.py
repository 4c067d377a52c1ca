"""The plain reference of the benchmark: finite volumes in plain torch on
a uniform box (box.py) or on any face list (mesh.py), one SIMPLE or
SIMPLE_FC iteration on them (simple.py, simple_fc.py; mesh_simple.py,
mesh_fc.py), and the comparison that decides `correct` (judge.py).
Nothing here imports the program."""
