"""HDFS high-availability namenode resolution and failover
(:mod:`.namenode`). Imports neither torch nor pyarrow's HDFS client until a
connection is made."""
