"""The plain reference of the benchmark: uniform-box finite volumes in
plain torch (box.py), one SIMPLE or SIMPLE_FC iteration on them
(simple.py, simple_fc.py), and the comparison that decides `correct`
(judge.py). Nothing here imports the program."""
