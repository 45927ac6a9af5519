"""The loops a cell drives, one module each, found by the name in the
cell's file under workloads/."""
