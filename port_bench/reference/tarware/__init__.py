"""The benchmark's plain reference of the warehouse env and its FIFO
dispatcher: frozen copies of the program's plain code, with the replan query
over every row (`pathfinding.py`)."""
