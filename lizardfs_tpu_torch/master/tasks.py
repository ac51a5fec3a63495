"""Incremental background metadata jobs — the TaskManager analog.

The reference executes long-running metadata work (recursive remove,
subtree setgoal/settrashtime, snapshots of huge trees) in small batches
from the event loop so client service never stalls (reference:
src/master/task_manager.h:141-150, recursive_remove_task.cc,
setgoal_task.cc). Same shape: a job yields work units; the manager runs
up to ``batch`` units per tick and reports progress/completion over the
admin protocol.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterator


@dataclass
class Task:
    task_id: int
    kind: str
    ops: Iterator[dict]  # yields op records to commit, one per unit
    done_units: int = 0
    finished: bool = False
    error: str = ""

    def to_dict(self) -> dict:
        return {
            "task_id": self.task_id, "kind": self.kind,
            "done_units": self.done_units, "finished": self.finished,
            "error": self.error,
        }


class TaskManager:
    def __init__(self, commit, batch: int = 64):
        """commit: callable(op_dict) — the master's one write path."""
        self._commit = commit
        self.batch = batch
        self._ids = itertools.count(1)
        self.tasks: dict[int, Task] = {}

    def submit(self, kind: str, ops: Iterator[dict]) -> Task:
        task = Task(next(self._ids), kind, ops)
        self.tasks[task.task_id] = task
        return task

    def tick(self) -> int:
        """Run one batch across all live tasks; returns units executed."""
        executed = 0
        for task in list(self.tasks.values()):
            if task.finished:
                continue
            for _ in range(self.batch):
                try:
                    op = next(task.ops)
                except StopIteration:
                    task.finished = True
                    break
                except Exception as e:  # noqa: BLE001
                    task.error = str(e)[:300]
                    task.finished = True
                    break
                try:
                    self._commit(op)
                except Exception as e:  # noqa: BLE001
                    # an op failing mid-job (e.g. concurrent mutation)
                    # records the error but doesn't kill the master
                    task.error = str(e)[:300]
                task.done_units += 1
                executed += 1
        # retire finished tasks after they have been visible for a while
        if len(self.tasks) > 256:
            for tid in sorted(self.tasks):
                if self.tasks[tid].finished:
                    del self.tasks[tid]
                if len(self.tasks) <= 128:
                    break
        return executed


# --- job generators ---------------------------------------------------------


def recursive_remove_ops(fs, parent: int, name: str, ts: int) -> Iterator[dict]:
    """Post-order removal of a subtree, one op per entry
    (recursive_remove_task analog). Validates eagerly; the tree is
    walked lazily, so concurrent changes surface as per-op errors."""
    root = fs.lookup(parent, name)  # raises before the task is submitted

    def one_file():
        yield {"op": "unlink", "parent": parent, "name": name, "ts": ts,
               "to_trash": True}

    if root.ftype != 2:
        return one_file()

    def walk(dir_inode: int):
        node = fs.nodes.get(dir_inode)
        if node is None:
            return
        for child_name, child in sorted(node.children.items()):
            cn = fs.nodes.get(child)
            if cn is not None and cn.ftype == 2:
                yield from walk(child)
                yield {"op": "rmdir", "parent": dir_inode, "name": child_name,
                       "ts": ts}
            else:
                yield {"op": "unlink", "parent": dir_inode,
                       "name": child_name, "ts": ts, "to_trash": True}

    def gen():
        yield from walk(root.inode)
        yield {"op": "rmdir", "parent": parent, "name": name, "ts": ts}

    return gen()


def subtree_setgoal_ops(fs, inode: int, goal: int, ts: int) -> Iterator[dict]:
    """Recursive setgoal (setgoal_task analog)."""
    fs.node(inode)  # eager validation

    def walk(i: int):
        node = fs.nodes.get(i)
        if node is None:
            return
        yield {"op": "setgoal", "inode": i, "goal": goal, "ts": ts}
        if node.ftype == 2:
            for child in sorted(node.children.values()):
                yield from walk(child)

    return walk(inode)


def subtree_settrashtime_ops(fs, inode: int, seconds: int, ts: int) -> Iterator[dict]:
    """Recursive settrashtime (settrashtime_task analog)."""
    fs.node(inode)  # eager validation

    def walk(i: int):
        node = fs.nodes.get(i)
        if node is None:
            return
        yield {
            "op": "setattr", "inode": i, "set_mask": 32, "mode": 0,
            "uid": 0, "gid": 0, "atime": 0, "mtime": 0, "ts": ts,
            "trash_time": seconds,
        }
        if node.ftype == 2:
            for child in sorted(node.children.values()):
                yield from walk(child)

    return walk(inode)
