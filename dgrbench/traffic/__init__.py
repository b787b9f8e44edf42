"""Traffic: the general generator of every mix (``pairs.py``) and the frozen
scene generators it draws from (``scenes.py``). A mix is a data file under
``dgrbench/workloads/``; nothing here imports the program."""
