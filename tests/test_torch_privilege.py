"""Privileges: CREATE USER / GRANT / REVOKE + enforcement (reference
pkg/privilege).

The twin of tests/test_privilege.py on tidb_tpu_torch, with device="cpu" at
every store."""
import pytest

from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch import errors


@pytest.fixture(autouse=True)
def _torch_registries():
    """The shared conftest resets tidb_tpu's registries only."""
    from tidb_tpu_torch.utils import device_guard, metrics, phase
    metrics.reset_all()
    device_guard.reset()
    phase.reset()
    yield


@pytest.fixture()
def tk():
    return TestKit(device="cpu")


def _as_user(tk, user):
    tk2 = tk.new_session()
    tk2.sess.user = user
    return tk2


def test_grant_flow(tk):
    tk.must_exec("create table p1 (a int)")
    tk.must_exec("insert into p1 values (1)")
    tk.must_exec("create user 'bob'@'%' identified by 'pw'")
    bob = _as_user(tk, "bob")
    with pytest.raises(errors.PrivilegeCheckFailError):
        bob.must_query("select * from p1")
    tk.must_exec("grant select on test.* to bob")
    bob.must_query("select * from p1").check([(1,)])
    with pytest.raises(errors.PrivilegeCheckFailError):
        bob.must_exec("insert into p1 values (2)")
    tk.must_exec("grant insert on test.p1 to bob")
    bob.must_exec("insert into p1 values (2)")
    tk.must_exec("revoke select on test.* from bob")
    with pytest.raises(errors.PrivilegeCheckFailError):
        bob.must_query("select * from p1")


def test_root_unrestricted_and_user_table(tk):
    tk.must_exec("create user carol identified by 'x'")
    r = tk.must_query("select user from mysql.user where user = 'carol'")
    assert r.rows == [("carol",)]
    # root still unrestricted after privilege system activates
    tk.must_exec("create table p2 (a int)")
    tk.must_exec("insert into p2 values (5)")
    tk.must_query("select * from p2").check([(5,)])


def test_auth(tk):
    tk.must_exec("create user dave identified by 'secret'")
    assert tk.domain.priv.auth("dave", "%", "secret")
    assert not tk.domain.priv.auth("dave", "%", "wrong")
    assert not tk.domain.priv.auth("nobody", "%", "")


def test_rbac_roles(tk):
    """CREATE ROLE / GRANT role / SET ROLE / default roles (reference
    pkg/privilege RBAC; MySQL role accounts + role_edges)."""
    tk.must_exec("create table pr1 (v int)")
    tk.must_exec("insert into pr1 values (42)")
    tk.must_exec("create role 'analyst'")
    tk.must_exec("grant select on test.* to 'analyst'")
    tk.must_exec("create user 'carol' identified by 'pw'")
    tk.must_exec("grant 'analyst' to 'carol'")
    carol = _as_user(tk, "carol")
    # granted but not active
    with pytest.raises(errors.PrivilegeCheckFailError):
        carol.must_query("select * from pr1")
    carol.must_exec("set role all")
    carol.must_query("select * from pr1").check([(42,)])
    carol.must_exec("set role none")
    with pytest.raises(errors.PrivilegeCheckFailError):
        carol.must_query("select * from pr1")
    # default roles activate in new sessions
    tk.must_exec("set default role all to 'carol'")
    carol2 = _as_user(tk, "carol")
    carol2.must_query("select * from pr1").check([(42,)])
    # role accounts cannot authenticate
    assert not tk.domain.priv.auth("analyst", "%", "")
    # SET ROLE of an ungranted role errors
    tk.must_exec("create role 'admin_r'")
    with pytest.raises(errors.TiDBError):
        carol.must_exec("set role 'admin_r'")
    # revoke cuts access
    tk.must_exec("revoke 'analyst' from 'carol'")
    carol3 = _as_user(tk, "carol")
    carol3.must_exec("set role all")
    with pytest.raises(errors.PrivilegeCheckFailError):
        carol3.must_query("select * from pr1")
    tk.must_exec("drop role 'analyst', 'admin_r'")
